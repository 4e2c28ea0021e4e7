"""K4 (``flash_prefill``) against its roofline: the least time the slice's
prefill chunks that run on K4 need (causal-attention FLOPs at the bf16 peak,
or q/k/v/out bytes at HBM bandwidth, the larger) over K4's device time."""
from flowbench import flops
from flowbench.readers import kernel_seconds, slice_chunks


def read(run):
    secs = kernel_seconds(run, "flash_prefill")
    if secs <= 0 or run.peak is None:
        return None
    costs = [flops.k4_chunk_cost(run.cfg, c["offset"], c["tokens"]) for c in slice_chunks(run)]
    costs = [c for c in costs if c is not None]
    total = {"flops": sum(c["flops"] for c in costs), "bytes": sum(c["bytes"] for c in costs)}
    return flops.roofline_pct(total, secs, run.peak, run.cfg["dtype"])
