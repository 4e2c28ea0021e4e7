"""The traced slice's work (closed-form FLOPs of its prefill chunks and
decode tokens) over the slice at the card's bf16 peak, in %."""
from flowbench.readers import mfu as read  # noqa: F401
