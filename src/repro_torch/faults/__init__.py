"""Deterministic, seeded fault injection for the serving plane.

One injector drives chaos on BOTH runtimes — ``PDCluster.step`` polls it on
the cycle clock, ``ClusterSim`` schedules its specs on the event clock — so
a chaos run is exactly as replayable as a clean one: the spec list + seed
round-trip through capture/replay meta (:func:`FaultInjector.to_meta` /
:func:`FaultInjector.from_meta`), and ``reset()`` rewinds all internal state
so the same injector instance re-runs identically.

Fault kinds (:class:`FaultSpec.kind`):

* ``node_crash``          — kill ``node_id`` at time ``at`` (one-shot).
* ``transfer_fail``       — a transfer attempt at/after ``at`` fails before
                            any bytes move (``count`` attempts, or a seeded
                            per-attempt ``rate``).
* ``transfer_corrupt``    — the attempt completes but the payload is
                            corrupted in flight; the post-dispatch checksum
                            catches it (``count`` / ``rate`` as above).
* ``degraded_bandwidth``  — transfers in ``[at, at + duration)`` are priced
                            ``factor``× slower (link flap / congestion).
* ``heartbeat_loss``      — ``node_id`` stops heartbeating during
                            ``[at, at + duration)`` without dying; staleness
                            detection fires, the node's work is requeued.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Iterable, List, Optional, Sequence, Union

KINDS = ("node_crash", "transfer_fail", "transfer_corrupt",
         "degraded_bandwidth", "heartbeat_loss")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    at: float = 0.0               # activation time (driving clock)
    node_id: Optional[int] = None  # node_crash / heartbeat_loss target
    count: int = 1                # transfer faults: budget of attempts hit
    factor: float = 1.0           # degraded_bandwidth: latency multiplier
    duration: float = 0.0         # degraded_bandwidth / heartbeat_loss window
    rate: float = 0.0             # transfer faults: per-attempt probability
    #                               (overrides count when > 0; seeded RNG)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {KINDS}")
        if self.kind in ("node_crash", "heartbeat_loss") and self.node_id is None:
            raise ValueError(f"{self.kind} needs a node_id")


class FaultInjector:
    """Schedules :class:`FaultSpec`\\ s against a driving clock.

    Stateful but rewindable: all mutable state (fired crashes, transfer
    budgets, the seeded RNG) reinitializes on :meth:`reset`, which both
    runtimes call at the start of a run.
    """

    def __init__(self, specs: Iterable[FaultSpec] = (), seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = int(seed)
        self.reset()

    def reset(self) -> None:
        self._fired: set = set()              # spec indices (node crashes)
        self._budget: Dict[int, int] = {
            i: s.count for i, s in enumerate(self.specs)
            if s.kind in ("transfer_fail", "transfer_corrupt") and s.rate <= 0}
        self._rng = random.Random(self.seed)

    # -- node crashes -------------------------------------------------------
    def due(self, now: float) -> List[FaultSpec]:
        """Unfired node_crash specs whose time has come (marks them fired)."""
        out = []
        for i, s in enumerate(self.specs):
            if s.kind == "node_crash" and i not in self._fired and now >= s.at:
                self._fired.add(i)
                out.append(s)
        return out

    def crash_specs(self) -> List[FaultSpec]:
        return [s for s in self.specs if s.kind == "node_crash"]

    # -- heartbeat loss -----------------------------------------------------
    def heartbeat_suppressed(self, node_id: int, now: float) -> bool:
        return any(s.kind == "heartbeat_loss" and s.node_id == node_id
                   and s.at <= now < s.at + s.duration for s in self.specs)

    def heartbeat_loss_specs(self) -> List[FaultSpec]:
        return [s for s in self.specs if s.kind == "heartbeat_loss"]

    # -- transfer faults ----------------------------------------------------
    def transfer_attempt(self, now: float) -> Optional[str]:
        """Verdict for ONE transfer attempt: None | "fail" | "corrupt".

        Deterministic: count-budgeted specs hit the first ``count`` attempts
        at/after ``at``; rate specs draw from the seeded RNG (the draw
        sequence is part of the replayable state)."""
        for i, s in enumerate(self.specs):
            if s.kind not in ("transfer_fail", "transfer_corrupt") or now < s.at:
                continue
            verdict = "fail" if s.kind == "transfer_fail" else "corrupt"
            if s.rate > 0:
                if self._rng.random() < s.rate:
                    return verdict
            elif self._budget.get(i, 0) > 0:
                self._budget[i] -= 1
                return verdict
        return None

    # -- degraded bandwidth -------------------------------------------------
    def bandwidth_factor(self, now: float) -> float:
        f = 1.0
        for s in self.specs:
            if s.kind == "degraded_bandwidth" and s.at <= now < s.at + s.duration:
                f *= s.factor
        return f

    # -- capture/replay meta ------------------------------------------------
    def to_meta(self) -> dict:
        return {"seed": self.seed,
                "specs": [dataclasses.asdict(s) for s in self.specs]}

    @classmethod
    def from_meta(cls, meta: dict) -> "FaultInjector":
        specs = [FaultSpec(**s) for s in meta.get("specs", [])]
        return cls(specs, seed=meta.get("seed", 0))


def as_injector(faults: Union[None, FaultInjector, dict,
                              Sequence[FaultSpec]]) -> Optional[FaultInjector]:
    """Normalize a runtime's ``faults=`` kwarg: an injector passes through,
    a meta dict (replay path) or a spec sequence builds a fresh one."""
    if faults is None or isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, dict):
        return FaultInjector.from_meta(faults)
    return FaultInjector(faults)
