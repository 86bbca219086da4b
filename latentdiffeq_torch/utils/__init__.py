from .profiling import PhaseTimer, trace_profile, enable_debug_nans

__all__ = ["PhaseTimer", "trace_profile", "enable_debug_nans"]
