"""Stress-scenario registry for the load-aware scheduling claim (paper
§3.3–§3.4, Tables 1–2 narrative).

The paper's second claim is that load-aware scheduling with flexible PD
allocation holds peak throughput across NORMAL, COMPUTATIONALLY IMBALANCED
and EXTREME-OVERLOAD traffic, on homogeneous and heterogeneous fleets.
Each :class:`Scenario` here pins one of those regimes as a deterministic
discrete-event simulation (fixed seeds, calibrated cost models — no wall
clock anywhere), and ``benchmarks/scenarios.py`` runs every scenario under
three routing policies (``load_aware`` / ``round_robin`` / ``static_pd``,
see ``sim.cluster_sim.ROUTING_POLICIES``) and gates the comparison in CI.

Goodput here is Mooncake's definition (arXiv:2407.00079): the fraction of
OFFERED requests that finish within the scenario's TTFT SLO. Early-rejected
requests count against goodput — the admission gate only wins if rejecting
some requests lets the rest meet the SLO, which is exactly the paper's
overload story.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import get_config
from repro_torch.core.scheduler.global_controller import AdmissionPolicy
from repro_torch.faults import FaultInjector, FaultSpec
from repro_torch.sim.cluster_sim import ClusterSim
from repro_torch.sim.hardware import A100, H20, L20, HardwareProfile
from repro_torch.sim.workload import (WorkloadSpec, generate,
                                generate_conversations, generate_mixture)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One reproducible stress regime: cluster shape + traffic + SLO."""

    name: str
    description: str
    num_prefill: int
    num_decode: int
    rps: float
    ttft_slo_s: float               # goodput gate: TTFT within this
    specs: Tuple[WorkloadSpec, ...]  # one -> generate; many -> mixture
    weights: Tuple[float, ...] = ()
    num_requests: int = 100
    hw_prefill: HardwareProfile = A100
    hw_decode: Optional[HardwareProfile] = None
    hw_nodes: Optional[Tuple[HardwareProfile, ...]] = None
    admission: Optional[AdmissionPolicy] = None   # load-aware policy only
    role_flip: bool = False                       # load-aware policy only
    same_host: bool = False
    t_max: float = 50_000.0
    seed: int = 0
    model: str = "llama31-8b"
    # chaos: FaultSpecs scheduled on the sim clock (a FRESH seeded injector
    # per build, so re-running a scenario re-fires identical faults) and the
    # staleness window for declaring a quiet node dead
    faults: Tuple[FaultSpec, ...] = ()
    heartbeat_timeout: float = 10.0
    # multi-turn chat (turns > 1): num_requests counts CONVERSATIONS, each
    # re-submitting its growing history every think_time_s; specs[0] shapes
    # the first turn (mean_input) and the per-turn output (mean_output)
    turns: int = 1
    think_time_s: float = 2.0
    user_turn_tokens: int = 128
    # pool shape: small pools + a host tier make the demote/promote plane
    # load-bearing instead of idle (tiered KV scenario)
    blocks_per_node: int = 8192
    host_tier_blocks: int = 0
    # mesh-parallel degrees, one per node index (empty = all TP=1). A TP=k
    # node runs the model sharded over k chips; cross-degree P->D transfers
    # price one fused dispatch per overlapping shard pair.
    tp_degrees: Tuple[int, ...] = ()

    def requests(self):
        if self.turns > 1:
            return generate_conversations(
                self.num_requests, self.turns, rps=self.rps,
                first_turn_tokens=self.specs[0].mean_input,
                user_turn_tokens=self.user_turn_tokens,
                output_tokens=self.specs[0].mean_output,
                think_time_s=self.think_time_s, seed=self.seed)
        if len(self.specs) == 1:
            spec = dataclasses.replace(self.specs[0],
                                       num_requests=self.num_requests)
            return generate(spec, rps=self.rps, seed=self.seed)
        return generate_mixture(list(self.specs), list(self.weights),
                                rps=self.rps, num_requests=self.num_requests,
                                seed=self.seed)

    def build(self, routing: str) -> ClusterSim:
        """A fresh simulator running this scenario under one routing policy.

        The admission gate and the role-flip response are part of what
        "load-aware" MEANS here, so they arm only on that policy — the
        baselines stay naive by construction (passive controller).
        """
        load_aware = routing == "load_aware"
        return ClusterSim(
            get_config(self.model), "flowkv",
            num_prefill=self.num_prefill, num_decode=self.num_decode,
            hw_prefill=self.hw_prefill, hw_decode=self.hw_decode,
            hw_nodes=self.hw_nodes, same_host=self.same_host,
            routing=routing,
            role_flip=self.role_flip and load_aware,
            admission=self.admission if load_aware else None,
            faults=FaultInjector(self.faults, seed=self.seed)
            if self.faults else None,
            heartbeat_timeout=self.heartbeat_timeout,
            blocks_per_node=self.blocks_per_node,
            host_tier_blocks=self.host_tier_blocks,
            tp_degrees={i: d for i, d in enumerate(self.tp_degrees)
                        if d > 1} or None,
        )

    def run(self, routing: str) -> Dict[str, float]:
        """Run under one policy; returns sim stats + goodput vs the SLO."""
        sim = self.build(routing)
        stats = sim.run(self.requests(), t_max=self.t_max)
        within_slo = sum(
            1 for r in sim.finished
            if r.ttft() is not None and r.ttft() <= self.ttft_slo_s)
        stats["goodput"] = within_slo / max(1, stats["offered"])
        stats["ttft_slo_s"] = self.ttft_slo_s
        return stats


# --------------------------------------------------------------------------
# the four regimes
# --------------------------------------------------------------------------
_IN_1K = WorkloadSpec("normal-1k", 1024, 256)
_PREFILL_HEAVY = WorkloadSpec("imbalance-prefill", 10240, 32)
_DECODE_HEAVY = WorkloadSpec("imbalance-decode", 512, 384)
_OVERLOAD = WorkloadSpec("overload-10k", 10240, 256)
_HET = WorkloadSpec("het-4k", 4096, 256)
_CHAT = WorkloadSpec("chat-turn", 1024, 128)

SCENARIOS: Dict[str, Scenario] = {
    # Balanced traffic on a balanced fleet: every policy should clear this;
    # load-aware must not LOSE anything when there is nothing to exploit.
    "normal": Scenario(
        name="normal",
        description="balanced 1k-ctx traffic, 2P2D A100 — sanity regime",
        num_prefill=2, num_decode=2, rps=1.0, ttft_slo_s=10.0,
        specs=(_IN_1K,), num_requests=100,
    ),
    # Computational imbalance: a prefill-heavy burst against a decode-heavy
    # 1P3D split. Load-aware flips idle decode nodes into prefill
    # (role_flip) and drains the burst; fixed-role baselines serialize it
    # through the single P node.
    "imbalance": Scenario(
        name="imbalance",
        description="prefill-heavy mixture on a decode-heavy 1P3D split — "
                    "flexible PD allocation is the win",
        num_prefill=1, num_decode=3, rps=1.5, ttft_slo_s=10.0,
        specs=(_PREFILL_HEAVY, _DECODE_HEAVY), weights=(0.8, 0.2),
        num_requests=120, role_flip=True,
    ),
    # Extreme overload: sustained arrivals far beyond 1P1D capacity. The
    # admission gate early-rejects what cannot meet the SLO anyway so the
    # admitted remainder still can; baselines queue everything and miss the
    # SLO across the board.
    "overload": Scenario(
        name="overload",
        description="10k-ctx traffic at ~4x 1P1D capacity — admission "
                    "control (early rejection) is the win",
        num_prefill=1, num_decode=1, rps=1.2, ttft_slo_s=10.0,
        specs=(_OVERLOAD,), num_requests=120,
        admission=AdmissionPolicy(ttft_slo_s=10.0, max_queue_depth=64,
                                  max_defer_cycles=6, reject_factor=1.5),
    ),
    # Heterogeneous fleet: compute-lean L20s prefill, bandwidth-rich H20s
    # decode, one A100 on each side. Capability normalization keeps the
    # weak cards from silently saturating and the strong cards from
    # starving; gate: everything finishes and NO node is starved.
    # Fault tolerance: moderate load on a 2P2D fleet with a prefill node
    # crashing mid-run, a flaky transfer link (failures + corruption caught
    # by checksums) and a degraded-bandwidth window. Gate
    # (benchmarks/fault_tolerance.py): goodput stays within a bounded
    # fraction of the fault-free A/B of this same scenario, every
    # non-cancelled request terminates, zero blocks leak.
    "failure": Scenario(
        name="failure",
        description="2P2D under node crash + flaky/degraded transfers — "
                    "token-exact recovery and bounded goodput loss",
        num_prefill=2, num_decode=2, rps=1.0, ttft_slo_s=30.0,
        specs=(_IN_1K,), num_requests=100,
        faults=(FaultSpec("node_crash", at=20.0, node_id=0),
                FaultSpec("transfer_fail", at=5.0, count=3),
                FaultSpec("transfer_corrupt", at=10.0, count=3),
                FaultSpec("degraded_bandwidth", at=15.0, duration=20.0,
                          factor=4.0)),
        heartbeat_timeout=2.0,
    ),
    # Multi-turn chat on deliberately small HBM pools: every turn re-submits
    # the growing conversation history, and between turns capacity pressure
    # demotes the cold history to the host-DRAM tier. The tiered store wins
    # by promoting it back (one fused dispatch) instead of recomputing;
    # benchmarks/tiered_kv.py A/Bs this same scenario tiered vs HBM-only.
    "multiturn": Scenario(
        name="multiturn",
        description="multi-turn conversations on small HBM pools — the "
                    "host-DRAM tier turns history recompute into promotion",
        num_prefill=1, num_decode=1, rps=0.5, ttft_slo_s=10.0,
        specs=(_CHAT,), num_requests=16, turns=4, think_time_s=4.0,
        blocks_per_node=384, host_tier_blocks=4096,
    ),
    "heterogeneous": Scenario(
        name="heterogeneous",
        description="mixed A100/L20 prefill + A100/H20 decode fleet — "
                    "capability-normalized scores are the win",
        num_prefill=2, num_decode=2, rps=1.2, ttft_slo_s=30.0,
        specs=(_HET,), num_requests=120,
        hw_nodes=(A100, L20, A100, H20),
    ),
    # Sharded heterogeneous fleet on a 70B-class model: a TP=4 prefill node
    # (4 chips, 4x aggregate FLOPs) feeds TP=1 decode nodes. Cross-degree
    # P->D transfers lower to tp_src + tp_dst - gcd = 4 fused dispatches per
    # request instead of per-shard fan-out; capability stamping scales the
    # prefill node's score by its degree so routing doesn't starve it.
    "sharded_heterogeneous": Scenario(
        name="sharded_heterogeneous",
        description="TP=4 70B-class prefill node feeding TP=1 decode nodes "
                    "— per-shard-pair fused transfer + degree-aware scores",
        num_prefill=1, num_decode=2, rps=0.6, ttft_slo_s=30.0,
        specs=(_HET,), num_requests=80,
        model="llama31-70b",
        tp_degrees=(4, 1, 1),
    ),
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError as e:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}") from e
