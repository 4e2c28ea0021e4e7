"""Share of the traced slice with no device record while the host enqueues a
forward (``decode_step`` or ``prefill_chunk`` launch phase), in
granite-4.0-h-small's cell: mostly a prefill chunk's eager enqueue."""
from flowbench.phases import launch_idle_pct as read  # noqa: F401
