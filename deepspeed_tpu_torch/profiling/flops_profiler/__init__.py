from .profiler import (FlopsProfiler, OpWalk, ProfileResult,
                       duration_to_string, flops_to_string,
                       get_model_profile, macs_to_string, params_to_string,
                       profile_fn)

__all__ = ["FlopsProfiler", "OpWalk", "ProfileResult", "get_model_profile",
           "profile_fn", "flops_to_string", "macs_to_string",
           "params_to_string", "duration_to_string"]
