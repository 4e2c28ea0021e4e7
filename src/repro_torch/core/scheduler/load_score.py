"""Weighted load scores C^p / C^d (paper Alg. 1, lines 8-15).

    C_i^p = w_r L_r^prefill + w_w L_w^prefill + w_sw L_sw^prefill + w_se L_se^prefill
          + w_t T_b + w_kv KV_u + w_g G_u + w_mb MB_u
    (and symmetrically C_i^d over the decode queues)

The paper sets the weights empirically ("determined through several
successful experiments"); the defaults below encode its stated intent:
prefill load is compute-driven (waiting queue + token budget + compute
util dominate), decode load is memory-driven (running queue + KV util +
bandwidth util dominate), and the sending queue signals transfer pressure
on both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.core.scheduler.metrics import NodeStatus


@dataclasses.dataclass(frozen=True)
class ScoreWeights:
    """Weights in the exact order of the paper's C^p/C^d sum (module
    docstring): w_r, w_w, w_sw, w_se, w_t, w_kv, w_g, w_mb. The field order
    IS the formula order — ``validate()`` guards the presets against silent
    drift (positional construction with reordered fields would change the
    score without any type error)."""

    running: float          # w_r   L_r   (running queue)
    waiting: float          # w_w   L_w   (waiting queue)
    swapped: float          # w_sw  L_sw  (swapped queue)
    sending: float          # w_se  L_se  (sending queue)
    token_budget: float     # w_t   T_b   (per-step token budget used)
    kv_util: float          # w_kv  KV_u  (KV pool occupancy)
    compute_util: float     # w_g   G_u   (MXU/SM busy fraction)
    bandwidth_util: float   # w_mb  MB_u  (HBM bandwidth busy fraction)

    def validate(self) -> "ScoreWeights":
        """Weights must be non-negative and sum to 1 (a convex combination:
        every feature is normalized to [0, 1], so scores stay comparable to
        the ε thresholds). Returns self so presets can validate inline."""
        vals = dataclasses.astuple(self)
        if any(v < 0.0 for v in vals):
            raise ValueError(f"score weights must be non-negative, got {self}")
        total = sum(vals)
        if abs(total - 1.0) > 1e-9:
            raise ValueError(
                f"score weights must sum to 1.0, got {total!r} for {self}")
        return self


# Prefill: compute-bound — queue backlog and compute utilization dominate.
PREFILL_WEIGHTS = ScoreWeights(
    running=0.20, waiting=0.30, swapped=0.05, sending=0.10,
    token_budget=0.15, kv_util=0.05, compute_util=0.15, bandwidth_util=0.00,
).validate()
# Decode: memory-bound — running batch, KV occupancy and HBM bw dominate.
DECODE_WEIGHTS = ScoreWeights(
    running=0.25, waiting=0.15, swapped=0.05, sending=0.05,
    token_budget=0.05, kv_util=0.25, compute_util=0.00, bandwidth_util=0.20,
).validate()


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """Regime thresholds ε (paper Alg. 1 lines 17/24).

    The paper leaves ε unspecified ("determined through several successful
    experiments"); these defaults are calibrated so that a node with a
    saturated queue + hot utilization signals scores ~0.8 (prefill) / ~0.55
    (decode) under the default weights, placing the high marks just below
    full saturation.
    """

    low_p: float = 0.35
    low_d: float = 0.30
    high_p: float = 0.60
    high_d: float = 0.45
    idle: float = 0.15          # node considered idle (role-switch candidate)
    scale_patience: int = 3     # consecutive extreme observations before scaling
    # ε_overload: when EVERY prefill-capable node's score exceeds this, the
    # admission gate stops admitting (defer, then early-reject) — Mooncake's
    # predicted-load early rejection, arXiv:2407.00079 §5.
    overload: float = 0.85


def node_score(status: NodeStatus, role: str) -> float:
    """Scalar load score for one node in one role, from a *smoothed* status.

    Heterogeneous fleets: the queue-length and token-budget terms measure
    *pending work*, so they are divided by the node's relative capability
    for the role (compute for prefill, HBM bandwidth for decode) — ten
    waiting prompts on an L20 are more load than ten on an A100, and the
    weak card therefore saturates "earlier" under the same ε thresholds.
    The three utilization fractions (KV / compute / bandwidth) are already
    measured against the node's OWN hardware and are not rescaled — a small
    pool at 90% is genuinely at 90%. Capability defaults to 1.0 (homogeneous
    fleet ≡ the paper's original formula).
    """
    if role == "prefill":
        w, pre = PREFILL_WEIGHTS, "prefill"
        work_cap = status.capability_compute
    elif role == "decode":
        w, pre = DECODE_WEIGHTS, "decode"
        work_cap = status.capability_memory
    else:
        raise ValueError(f"role must be 'prefill' or 'decode', got {role!r}")
    work_cap = max(work_cap, 1e-6)
    queue_load = (
        w.running * getattr(status, f"running_{pre}")
        + w.waiting * getattr(status, f"waiting_{pre}")
        + w.swapped * getattr(status, f"swapped_{pre}")
        + w.sending * getattr(status, f"sending_{pre}")
        + w.token_budget * status.token_budget_used
    )
    return (
        queue_load / work_cap
        + w.kv_util * status.kv_utilization
        + w.compute_util * status.compute_utilization
        + w.bandwidth_util * status.bandwidth_utilization
    )


def cluster_scores(statuses: Dict[int, NodeStatus], prefill_nodes: Sequence[int],
                   decode_nodes: Sequence[int]) -> tuple[float, float]:
    """C^p = mean over P nodes, C^d = mean over D nodes (Alg. 1 lines 12-15)."""
    cp = (sum(node_score(statuses[i], "prefill") for i in prefill_nodes) / len(prefill_nodes)
          if prefill_nodes else 0.0)
    cd = (sum(node_score(statuses[i], "decode") for i in decode_nodes) / len(decode_nodes)
          if decode_nodes else 0.0)
    return cp, cd


def classify_regime(cp: float, cd: float, th: Thresholds) -> str:
    """normal | imbalanced | extreme  (Alg. 1 lines 16-31).

    normal:     both scores low.
    imbalanced: exactly one side hot (or moderately loaded but skewed).
    extreme:    both beyond the high threshold (overload) — or both ~zero
                for a long time (low-load; handled by the elastic manager).
    """
    if cp <= th.low_p and cd <= th.low_d:
        return "normal"
    if cp > th.high_p and cd > th.high_d:
        return "extreme"
    return "imbalanced"
