"""Tracing and timing hooks, and numerics debugging."""
from medseg_tpu_torch.utils.profiling import StepTimer, trace_context  # noqa: F401
from medseg_tpu_torch.utils.debug import nan_check_mode, assert_finite  # noqa: F401
