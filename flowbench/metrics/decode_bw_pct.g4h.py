"""The decode step against its bandwidth roofline in granite-4.0-h-small's
cell: the bytes each traced step must move (the held weights once, the
Mamba-2 state its real lanes read and write, its ``state_bytes`` attr, and
its real lanes' cached K/V, ``context_tokens`` x the K/V bytes a token) at
HBM bandwidth, over the steps' walls, in %. None where the steps carry no
``state_bytes`` (a program without state slots) or on the CPU."""
from typing import Optional

from flowbench import flops
from flowbench.phases import slice_decode_steps


def held_weight_bytes(cfg) -> float:
    """Every weight this card holds: the layers with all the held experts
    and the router at its published width, and the tied embedding."""
    held = cfg["num_local_experts"]
    body = flops.body_params_active(dict(cfg, num_experts_per_tok=held))
    router = cfg["hidden_size"] * (cfg["published"]["num_local_experts"] - held)
    params = body + cfg["num_hidden_layers"] * router + cfg["vocab_size"] * cfg["hidden_size"]
    return float(params * flops.DTYPE_BYTES[cfg["dtype"]])


def read(run) -> Optional[float]:
    steps = [s for s in slice_decode_steps(run) if "state_bytes" in s.attrs]
    if not steps or run.peak is None:
        return None
    cfg = run.cfg
    weights = held_weight_bytes(cfg)
    moved = sum(weights + s.attrs["state_bytes"]
                + s.attrs["context_tokens"] * flops.kv_bytes_per_token(cfg) for s in steps)
    wall = sum(s.duration_wall_s() for s in steps)
    return 100.0 * moved / (wall * run.peak["hbm_bytes_s"])
