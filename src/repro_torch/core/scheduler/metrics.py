"""Node status vector S_i and sliding-window smoothing (paper App. B.2).

The paper samples, per node: running/waiting/swapped/sending queue lengths
for both roles, token budget, KV-cache utilization, compute utilization and
memory-bandwidth utilization, then smooths with a sliding window because
"instantaneous sampling can result in significant fluctuations".
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Iterable, List

STATUS_FIELDS = (
    "running_prefill", "waiting_prefill", "swapped_prefill", "sending_prefill",
    "running_decode", "waiting_decode", "swapped_decode", "sending_decode",
    "token_budget_used",     # fraction of per-step token budget consumed
    "kv_utilization",        # KV_u
    "compute_utilization",   # G_u   (MXU busy fraction on TPU)
    "bandwidth_utilization", # MB_u  (HBM bw busy fraction)
)


@dataclasses.dataclass(frozen=True)
class NodeStatus:
    """One instantaneous sample of a node's load vector S_i.

    The ``capability_*`` fields are NOT part of the sampled load vector
    (they are hardware constants, not signals): the global controller stamps
    them onto every smoothed status before scoring, so a heterogeneous fleet
    scores comparably — see :func:`repro_torch.core.scheduler.load_score.node_score`.
    They are relative to the fleet maximum, in (0, 1].
    """

    running_prefill: float = 0.0
    waiting_prefill: float = 0.0
    swapped_prefill: float = 0.0
    sending_prefill: float = 0.0
    running_decode: float = 0.0
    waiting_decode: float = 0.0
    swapped_decode: float = 0.0
    sending_decode: float = 0.0
    token_budget_used: float = 0.0
    kv_utilization: float = 0.0
    compute_utilization: float = 0.0
    bandwidth_utilization: float = 0.0
    # hardware capability relative to fleet max (stamped by the controller)
    capability_compute: float = 1.0     # peak FLOPs / fleet-max FLOPs
    capability_memory: float = 1.0      # HBM bandwidth / fleet-max bandwidth
    capability_kv: float = 1.0          # HBM capacity / fleet-max capacity
    # mesh-parallel topology (constants like capability_*, NOT load signals;
    # stamped by the controller after smoothing/normalization — anything
    # rebuilding a NodeStatus from STATUS_FIELDS drops them back to 1)
    tp_degree: float = 1.0              # tensor-parallel degree of the node
    ep_degree: float = 1.0              # expert-parallel degree (MoE; else 1)

    def as_dict(self) -> Dict[str, float]:
        return {f: getattr(self, f) for f in STATUS_FIELDS}

    def with_capability(self, compute: float, memory: float,
                        kv: float) -> "NodeStatus":
        """Stamp relative hardware capability onto a (smoothed) sample."""
        return dataclasses.replace(
            self, capability_compute=compute, capability_memory=memory,
            capability_kv=kv)

    def with_sharding(self, tp_degree: float, ep_degree: float) -> "NodeStatus":
        """Stamp the node's mesh-parallel degrees onto a (smoothed) sample."""
        return dataclasses.replace(
            self, tp_degree=tp_degree, ep_degree=ep_degree)


class SlidingWindow:
    """Per-field moving average over the last ``window`` samples."""

    def __init__(self, window: int = 8):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self._hist: Deque[NodeStatus] = collections.deque(maxlen=window)

    def push(self, status: NodeStatus) -> None:
        self._hist.append(status)

    def __len__(self) -> int:
        return len(self._hist)

    def smoothed(self) -> NodeStatus:
        if not self._hist:
            return NodeStatus()
        acc = {f: 0.0 for f in STATUS_FIELDS}
        for s in self._hist:
            for f in STATUS_FIELDS:
                acc[f] += getattr(s, f)
        n = len(self._hist)
        return NodeStatus(**{f: v / n for f, v in acc.items()})


def normalize(statuses: List[NodeStatus]) -> List[NodeStatus]:
    """Cluster-wide max-normalization so heterogeneous nodes are comparable.

    Queue lengths are unbounded counts; utilizations are already in [0, 1].
    The paper: "we normalize all data to effectively assess each node's load
    status".
    """
    if not statuses:
        return []
    queue_fields = [f for f in STATUS_FIELDS
                    if f.startswith(("running", "waiting", "swapped", "sending"))]
    maxima = {f: max(1.0, max(getattr(s, f) for s in statuses)) for f in queue_fields}
    out = []
    for s in statuses:
        d = s.as_dict()
        for f in queue_fields:
            d[f] = d[f] / maxima[f]
        out.append(NodeStatus(**d))
    return out
