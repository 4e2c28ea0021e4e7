"""Median wall of the program's ``decode_step`` spans in granite-4.0-h-small's
cell: one batched step over the pages and the state slots."""
from flowbench.phases import step_wall_p50_ms as read  # noqa: F401
