from .profiling import (PhaseTimer, device_profile, enable_debug_nans,
                        graph_nodes, lost_kernel_records, trace_profile)

__all__ = ["PhaseTimer", "device_profile", "trace_profile",
           "lost_kernel_records", "graph_nodes", "enable_debug_nans"]
