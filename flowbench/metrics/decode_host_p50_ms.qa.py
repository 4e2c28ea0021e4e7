"""Median of each ``decode_step`` span's wall less its upload and readback
phases: the host's own time a step (block tables and padding, the forward's
enqueue, the tokens' bookkeeping), in the window before the profiler."""
from flowbench.phases import step_host_p50_ms as read  # noqa: F401
