"""Median of each ``decode_step`` span's wall less its upload and readback
phases (the host's own time a step), in granite-4.0-h-small's cell."""
from flowbench.phases import step_host_p50_ms as read  # noqa: F401
