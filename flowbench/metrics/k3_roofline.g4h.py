"""K3 (``paged_decode``) against its roofline in granite-4.0-h-small's cell:
the least time the slice's decode steps need over the 4 attention layers'
cached tokens (K/V bytes at HBM bandwidth, or attention FLOPs at the bf16
peak, the larger) over K3's device time."""
from flowbench.phases import k3_roofline as read  # noqa: F401
