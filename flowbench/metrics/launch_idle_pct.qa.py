"""Share of the traced slice in which no device record ran while the host
was in the launch phase (the forward's enqueue) of a ``decode_step`` or a
``prefill_chunk`` span, the spans placed on the device's clock."""
from flowbench.phases import launch_idle_pct as read  # noqa: F401
