"""Median wall of the program's ``decode_step`` spans (one engine decode
step over its whole batch, entry to the scheduler's update) in the window
before the profiler started."""
from flowbench.phases import step_wall_p50_ms as read  # noqa: F401
