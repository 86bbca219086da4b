from .profiling import (PAD, PAD_KERNEL, PhaseTimer, device_profile,
                        enable_debug_nans, graph_nodes, lost_kernel_records,
                        trace_profile)

__all__ = ["PhaseTimer", "device_profile", "trace_profile", "PAD",
           "PAD_KERNEL", "lost_kernel_records", "graph_nodes",
           "enable_debug_nans"]
