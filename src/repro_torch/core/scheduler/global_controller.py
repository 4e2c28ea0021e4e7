"""Global controller: regime detection, routing, role switching, elastic
scaling, and the fault path (paper §3.4, Alg. 1, App. B).

The controller is deliberately runtime-agnostic: it sees nodes through
:class:`NodeHandle` (role, topology coordinates, hardware, and the node's
:class:`HybridScheduler`), so the same controller drives the real CPU-scale
cluster (``serving/cluster.py``) and the discrete-event simulator
(``sim/cluster_sim.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import (TransportProfile,
                                  estimate_overlapped_transfer_s,
                                  predicted_chunked_ttft_s, predicted_ttft_s,
                                  select_route, sharded_transfer_calls,
                                  tier_fetch_latency)
from repro_torch.core.scheduler.hybrid_scheduler import HybridScheduler
from repro_torch.core.scheduler.load_score import (Thresholds, classify_regime,
                                             cluster_scores, node_score)
from repro_torch.core.scheduler.metrics import NodeStatus, normalize
from repro_torch.serving.prefix_cache import TIER_HBM, PrefixCacheIndex
from repro_torch.serving.request import Request, RequestState
from repro_torch.sim.hardware import HardwareProfile


@dataclasses.dataclass
class NodeHandle:
    node_id: int
    role: str                      # "prefill" | "decode"
    host_id: int                   # GPU world: machine; TPU world: pod
    hardware: HardwareProfile
    scheduler: HybridScheduler
    alive: bool = True
    last_heartbeat: float = 0.0
    # False for engines whose data plane cannot reuse a resident prefix
    # (state-path families, windowed attention): routing never stamps a
    # prefix plan onto requests bound for such a node.
    supports_prefix_reuse: bool = True
    # Temporary role override (imbalanced regime role switch).
    switched_until_cycle: int = -1
    # Set when the flip policy reassigned this node away from its original
    # role; the controller flips it back once the cluster re-balances.
    home_role: Optional[str] = None
    # Mesh-parallel degrees: a tp>1 node runs its model sharded over
    # tp_degree devices (its hardware profile describes ONE device, so
    # capability/estimate terms scale by the degree); ep_degree is the
    # expert-parallel degree (MoE configs; 1 otherwise).
    tp_degree: int = 1
    ep_degree: int = 1


@dataclasses.dataclass
class ModelCost:
    """Per-token cost constants the controller uses for its estimates."""

    flops_per_token: float          # prefill FLOPs per prompt token (~2N)
    kv_bytes_per_token: float       # KV cache bytes per token (all layers)
    weight_bytes: float             # bytes read per decode step (weights)


@dataclasses.dataclass
class ControllerEvent:
    cycle: int
    kind: str                       # "role_switch" | "scale_up" | "scale_down" | "failover" | "regime" | "admission"
    detail: str


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Overload admission gate (Mooncake-style early rejection + P/D-Serve
    SLO gating). Disabled unless passed to :class:`GlobalController` — with
    no policy the controller admits everything, exactly as before.

    A request is ADMITTED when some prefill-capable node can still honor it:
    predicted TTFT (queued prefill work + own compute, capability-aware)
    within ``ttft_slo_s``, waiting depth below ``max_queue_depth``, and not
    every node's prefill score beyond ``Thresholds.overload`` (ε_overload).
    Otherwise it is DEFERRED (parked controller-side, re-evaluated every
    cycle — admitted as soon as load drains) unless the overload is deep
    (predicted TTFT beyond ``reject_factor`` x SLO) or the request has waited
    ``max_defer_cycles``, in which case it is REJECTED with a retry-after
    hint so the client backs off instead of piling on.
    """

    ttft_slo_s: float = 30.0        # predicted-TTFT admission budget
    max_queue_depth: int = 128      # per-node waiting+running prefill cap
    max_defer_cycles: int = 8       # deferred longer than this -> rejected
    reject_factor: float = 2.0      # predicted TTFT > factor*slo -> reject now
    retry_after_floor_s: float = 1.0


@dataclasses.dataclass
class AdmissionDecision:
    verdict: str                          # "admitted" | "deferred" | "rejected"
    predicted_ttft_s: float = 0.0
    retry_after_s: Optional[float] = None
    reason: str = ""
    route: Optional[Tuple[int, int]] = None   # (prefill, decode) when admitted

    @property
    def admitted(self) -> bool:
        return self.verdict == "admitted"


class GlobalController:
    def __init__(self, model_cost: ModelCost, block_size: int,
                 thresholds: Optional[Thresholds] = None,
                 target: str = "gpu",
                 heartbeat_timeout: float = 10.0,
                 role_switch_cycles: int = 4,
                 role_flip: bool = False,
                 node_factory: Optional[Callable[[str], NodeHandle]] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 actions_enabled: bool = True,
                 layer_window: int = 0,
                 num_layers: int = 1):
        self.model_cost = model_cost
        # Layerwise transfer/compute overlap: when the runtime streams KV in
        # per-layer-window sub-plans, routing must price the EXPOSED (post-
        # prefill) latency, not the full wire time — otherwise load-aware
        # placement can't see the gain the data plane realizes. layer_window
        # <= 0 keeps the classic single-call estimate.
        self.layer_window = layer_window
        self.num_layers = max(1, num_layers)
        self.thresholds = thresholds or Thresholds()
        self.target = target
        self.heartbeat_timeout = heartbeat_timeout
        self.role_switch_cycles = role_switch_cycles
        # role_flip=True upgrades the imbalanced-regime response from a
        # bounded priority lease to a FULL role reassignment (set_role),
        # reverted automatically once the cluster re-balances.
        self.role_flip = role_flip
        self.node_factory = node_factory   # elastic scale-up hook
        # Overload admission gate; None admits everything (legacy behavior).
        self.admission = admission
        # actions_enabled=False makes the controller PASSIVE: it still
        # samples, scores, classifies and detects failures, but takes no
        # regime actions (role switch / flip / scale / admission). This is
        # how the scenario suite runs its round-robin / static-PD baselines
        # through the same code without load-aware behavior leaking in.
        self.actions_enabled = actions_enabled
        # Optional repro_torch.obs.tracing.SpanRecorder: when set AND an admission
        # policy is armed, every gate verdict becomes an "admission" span.
        self.tracer = None
        self.nodes: Dict[int, NodeHandle] = {}
        self.prefix_index = PrefixCacheIndex(block_size)
        self.cycle = 0
        self.regime = "normal"
        self._extreme_streak = 0
        self._low_streak = 0
        self._normal_streak = 0   # flip-back hysteresis (see _flip_back)
        self.events: List[ControllerEvent] = []
        self.retry_queue: List[Request] = []
        # admission gate state: parked (deferred) requests and the rejected
        # outbox the runtime drains for bookkeeping (PDCluster / ClusterSim).
        self.deferred: List[Request] = []
        self.rejected_outbox: List[Request] = []
        # hook for event-driven runtimes: called with each request admitted
        # OUTSIDE submit (deferred admissions, failover reroutes) so the
        # simulator can poke the target node's scheduling loop.
        self.on_admit: Optional[Callable[[Request], None]] = None

    # -- membership ---------------------------------------------------------------
    def register_node(self, node: NodeHandle) -> None:
        self.nodes[node.node_id] = node

    def prefill_nodes(self) -> List[NodeHandle]:
        return [n for n in self.nodes.values() if n.alive and n.role == "prefill"]

    def decode_nodes(self) -> List[NodeHandle]:
        return [n for n in self.nodes.values() if n.alive and n.role == "decode"]

    # -- heterogeneous capability profiles -----------------------------------------
    def _capabilities(self) -> Dict[int, Tuple[float, float, float]]:
        """Per-node (compute, bandwidth, capacity) relative to the fleet max.

        Derived from each :class:`NodeHandle`'s hardware profile, so a mixed
        L20/H20/A100 fleet scores on a common scale: the strongest card in
        each dimension is 1.0 and weaker cards saturate proportionally
        earlier (see ``load_score.node_score``). Homogeneous fleets collapse
        to all-ones, i.e. the paper's original un-normalized formula.
        """
        alive = [n for n in self.nodes.values() if n.alive]
        if not alive:
            return {}
        # a node's hardware profile describes ONE device; a tp>1 node
        # aggregates tp devices' FLOPs, bandwidth and HBM, so its capability
        # terms scale by the degree (e.g. a TP=4 prefill node absorbs 4x the
        # backlog of a TP=1 node of the same card before saturating)
        max_f = max(n.hardware.peak_flops * n.tp_degree for n in alive)
        max_b = max(n.hardware.hbm_bandwidth * n.tp_degree for n in alive)
        max_m = max(n.hardware.hbm_bytes * n.tp_degree for n in alive)
        return {
            n.node_id: (n.hardware.peak_flops * n.tp_degree / max_f,
                        n.hardware.hbm_bandwidth * n.tp_degree / max_b,
                        n.hardware.hbm_bytes * n.tp_degree / max_m)
            for n in alive
        }

    def _scored_status(self, node: NodeHandle,
                       caps: Optional[Dict[int, Tuple[float, float, float]]] = None
                       ) -> NodeStatus:
        """A node's smoothed status with its capability profile stamped on."""
        caps = caps if caps is not None else self._capabilities()
        status = node.scheduler.smoothed_status()
        c = caps.get(node.node_id)
        return status.with_capability(*c) if c else status

    # -- node lifecycle -------------------------------------------------------------
    def set_role(self, node_id: int, role: str) -> bool:
        """Reassign a node P<->D mid-run.

        Routing sees the new role immediately; the node's scheduler gets a
        sticky priority matching it. In-flight work of the OLD role keeps
        running from the same block pool (NodeEngine is role-flexible), so
        no drain is needed. Returns True if the role actually changed.
        """
        if role not in ("prefill", "decode"):
            raise ValueError(f"role must be 'prefill' or 'decode', got {role!r}")
        node = self.nodes[node_id]
        if node.role == role:
            return False
        old = node.role
        node.role = role
        node.switched_until_cycle = -1
        node.scheduler.set_priority(role, cycles=0)   # sticky until next set_role
        self._log("set_role", f"node {node_id}: {old} -> {role}")
        return True

    # -- heartbeat / fault tolerance ---------------------------------------------------
    def heartbeat(self, node_id: int, now: float) -> None:
        if node_id in self.nodes:
            self.nodes[node_id].last_heartbeat = now

    def detect_failures(self, now: float) -> List[int]:
        """Mark STALE nodes dead, drain their requests into the retry queue.

        Liveness is pure staleness against ``heartbeat_timeout`` — there is
        no sentinel stamp; a killed node simply stops heartbeating and falls
        over this threshold like a genuinely crashed one would. Each drained
        request is stamped ``recovery_start`` (its failover clock starts
        here) and gets a ``failure`` span when a tracer is attached.
        """
        failed = []
        for node in self.nodes.values():
            if node.alive and now - node.last_heartbeat > self.heartbeat_timeout:
                node.alive = False
                failed.append(node.node_id)
                drained = node.scheduler.drain_for_failure()
                for req in drained:
                    self._stamp_failure(req, now, node.node_id,
                                        "heartbeat_timeout")
                self.retry_queue.extend(drained)
                self.prefix_index.evict_node(node.node_id)
                self._log("failover",
                          f"node {node.node_id} dead; requeued {len(drained)} requests")
        return failed

    def _stamp_failure(self, req: Request, now: float, node_id: int,
                       reason: str) -> None:
        """Start a request's recovery clock + emit its ``failure`` span."""
        if req.recovery_start is None:
            req.recovery_start = now
            if self.tracer is not None:
                req.recovery_start_wall = self.tracer.wall()
        if self.tracer is not None:
            wall = self.tracer.wall()
            self.tracer.emit(
                req.request_id, "failure",
                start_cycle=float(now), end_cycle=float(now),
                start_wall_s=wall, end_wall_s=wall, node_id=node_id,
                attrs={"reason": reason, "retries": req.retries,
                       "tokens_kept": len(req.output_tokens)})

    def reroute_retries(self) -> int:
        """Re-dispatch requests drained from failed nodes.

        Only FAILED requests are still owed a reroute (a client cancel in
        the retry queue flips the state and is dropped here). An unroutable
        request stays queued for a later cycle instead of being silently
        discarded — with zero alive nodes the queue simply waits.
        """
        n = 0
        pending = list(self.retry_queue)
        self.retry_queue = []
        while pending:
            req = pending.pop()
            if req.state is not RequestState.FAILED:
                continue
            if self.route_request(req) is None:
                self.retry_queue.append(req)
                self.retry_queue.extend(r for r in reversed(pending)
                                        if r.state is RequestState.FAILED)
                break
            n += 1
            if self.on_admit is not None:
                self.on_admit(req)
        return n

    # -- overload admission gate ---------------------------------------------------------
    def submit_request(self, req: Request) -> AdmissionDecision:
        """Front door: admission gate, then routing.

        With no :class:`AdmissionPolicy` this is exactly ``route_request``.
        With one, the request is admitted / deferred / early-rejected based
        on predicted TTFT, queue depth and ε_overload — overload never piles
        more work onto a cluster that cannot meet the SLO anyway.
        """
        decision = self._admission_check(req)
        self._trace_admission(req, decision)
        if decision.verdict == "admitted":
            decision.route = self.route_request(req)
        elif decision.verdict == "deferred":
            self.deferred.append(req)
            req.retry_after = decision.retry_after_s
            self._log("admission",
                      f"deferred request {req.request_id}: {decision.reason}")
        else:
            self._reject(req, decision)
        return decision

    def _admission_check(self, req: Request) -> AdmissionDecision:
        if self.admission is None or not self.actions_enabled:
            return AdmissionDecision("admitted")
        pol = self.admission
        pnodes = self.prefill_nodes() or \
            [n for n in self.nodes.values() if n.alive]
        if not pnodes:
            # no alive nodes: let route_request surface the hard failure
            return AdmissionDecision("admitted")
        best_ttft = min(self._ttft_estimate(n, req) for n in pnodes)
        depth_ok = any(
            len(n.scheduler.prefill.waiting) + len(n.scheduler.prefill.running)
            < pol.max_queue_depth for n in pnodes)
        # ε_overload compares on the SAME scale step() classifies on: queue
        # counts normalized across the fleet to [0, 1] (raw counts would
        # blow past the threshold at a handful of queued requests), then
        # capability-stamped.
        caps = self._capabilities()
        norm = normalize([n.scheduler.smoothed_status() for n in pnodes])
        min_score = min(
            node_score(s.with_capability(*caps.get(n.node_id, (1.0,) * 3)),
                       "prefill")
            for n, s in zip(pnodes, norm))
        overloaded = min_score > self.thresholds.overload
        if best_ttft <= pol.ttft_slo_s and depth_ok and not overloaded:
            return AdmissionDecision("admitted", predicted_ttft_s=best_ttft)
        if best_ttft > pol.ttft_slo_s:
            reason = f"predicted_ttft {best_ttft:.2f}s > slo {pol.ttft_slo_s:.2f}s"
        elif not depth_ok:
            reason = f"every node at queue depth >= {pol.max_queue_depth}"
        else:
            reason = (f"every node's C^p {min_score:.2f} > "
                      f"eps_overload {self.thresholds.overload:.2f}")
        retry = max(pol.retry_after_floor_s, best_ttft - pol.ttft_slo_s)
        deep = best_ttft > pol.reject_factor * pol.ttft_slo_s
        if deep or req.admission_defers >= pol.max_defer_cycles:
            return AdmissionDecision("rejected", best_ttft, retry, reason)
        return AdmissionDecision("deferred", best_ttft, retry, reason)

    def _trace_admission(self, req: Request,
                         decision: AdmissionDecision) -> None:
        """One instantaneous "admission" span per gate verdict (the QUEUE
        span covers the time a deferral costs; this records the decision)."""
        if self.tracer is None or self.admission is None \
                or not self.actions_enabled:
            return
        wall = self.tracer.wall()
        self.tracer.emit(
            req.request_id, "admission",
            start_cycle=float(self.cycle), end_cycle=float(self.cycle),
            start_wall_s=wall, end_wall_s=wall,
            attrs={"verdict": decision.verdict,
                   "predicted_ttft_s": decision.predicted_ttft_s,
                   "reason": decision.reason,
                   "defers": req.admission_defers})

    def _reject(self, req: Request, decision: AdmissionDecision) -> None:
        req.state = RequestState.REJECTED
        req.retry_after = decision.retry_after_s
        req.reject_reason = decision.reason
        self.rejected_outbox.append(req)
        self._log("admission",
                  f"rejected request {req.request_id}: {decision.reason}")

    def take_rejected(self) -> List[Request]:
        """Drain the rejected outbox (runtime bookkeeping hook)."""
        out, self.rejected_outbox = self.rejected_outbox, []
        return out

    def _drain_deferred(self) -> None:
        """Re-evaluate parked requests; admit as load drains, reject stale."""
        if not self.deferred:
            return
        still: List[Request] = []
        for req in self.deferred:
            req.admission_defers += 1
            decision = self._admission_check(req)
            self._trace_admission(req, decision)
            if decision.verdict == "admitted" and self.route_request(req) is not None:
                req.retry_after = None
                self._log("admission",
                          f"admitted deferred request {req.request_id} "
                          f"after {req.admission_defers} cycles")
                if self.on_admit is not None:
                    self.on_admit(req)
            elif decision.verdict == "rejected":
                self._reject(req, decision)
            else:
                still.append(req)
        self.deferred = still

    # -- normal-regime routing (Alg. 1 lines 18-23) --------------------------------------
    def _chain_for(self, req: Request) -> List[bytes]:
        """The request's prompt digest chain, hashed ONCE per request.

        Cached on the request (the prompt is immutable, so the chain
        survives retries): admission resolvers and fetch-validation retries
        probe every cycle, and re-hashing a long prompt each time would be
        pure control-plane overhead."""
        chain = req.prefix_chain_cache
        if chain is None:
            chain = self.prefix_index.chain(req.prompt_tokens)
            req.prefix_chain_cache = chain
        return chain

    def shareable_prefix(self, node_id: int, req: Request,
                         hashes=None) -> Tuple[int, List[int], List[str]]:
        """A node's SHAREABLE prefix for ``req``: full blocks only, capped so
        at least one suffix token is always computed (the last prompt token's
        forward emits the first output token). Returns ``(hit_tokens,
        block_ids, tiers)`` — ``tiers[i]`` names the tier backing
        ``block_ids[i]`` (``"hbm"`` pool blocks are directly shareable,
        ``"dram"`` host blocks must be promoted first)."""
        if hashes is None:
            hashes = self._chain_for(req)
        m = self.prefix_index.lookup(node_id, req.prompt_tokens, hashes)
        bs = self.prefix_index.block_size
        nb = min(len(m.block_ids), max(0, req.prompt_len - 1) // bs)
        return nb * bs, m.block_ids[:nb], m.tiers[:nb]

    def resolve_local_prefix(self, node_id: int, req: Request,
                             block_alive: Callable[[int], bool]) -> List[int]:
        """Admission-time prefix resolution (the ``resolve_prefix`` hook
        body, shared by ``PDCluster`` and ``ClusterSim`` so engine and sim
        semantics cannot drift): re-stamp the request with the reuse THIS
        node can actually deliver and return the shareable block ids.
        ``block_alive`` is the node's own liveness check (belt and braces —
        index drift past the on_free invalidation would be a bug).

        Only the leading HBM-backed, live run is shareable: a ``dram``
        entry mid-chain means the runtime's promote pass has not (or could
        not) lift it back into the pool, so the match truncates there —
        reuse degrades, it never dereferences a host block as a pool block.
        """
        hit, blocks, tiers = self.shareable_prefix(node_id, req)
        nb = 0
        for b, t in zip(blocks, tiers):
            if t != TIER_HBM or not block_alive(b):
                break
            nb += 1
        blocks = blocks[:nb]
        hit = min(hit, nb * self.prefix_index.block_size)
        req.num_cached_prefix_tokens = hit
        req.prefix_src_node = node_id if hit else None
        req.prefix_block_ids = list(blocks)
        return blocks

    def route_request(self, req: Request) -> Optional[Tuple[int, int]]:
        """Pick (prefill_node, decode_node); enqueue prefill; return ids.

        Prefix-aware (paper §3.2 "identifies global cache prefix matches"):
        for every prefill candidate the controller prices three plans —
        reuse the node's LOCAL resident prefix, FETCH a longer prefix from
        the best remote holder (one fused descriptor-table transfer, priced
        by ``core.costmodel``), or RECOMPUTE from scratch (the local plan
        with a zero hit) — and routes to the globally cheapest predicted
        TTFT. The winning plan is stamped on the request
        (``num_cached_prefix_tokens`` / ``prefix_src_node`` /
        ``prefix_block_ids``); the runtime executes the fetch and the node's
        scheduler re-validates local hits at admission time.
        """
        pnodes = self.prefill_nodes()
        dnodes = self.decode_nodes()
        if not pnodes or not dnodes:
            # Degenerate cluster (all one role): hybrid nodes take both stages.
            pnodes = pnodes or list(self.nodes.values())
            dnodes = dnodes or pnodes
            pnodes = [n for n in pnodes if n.alive]
            dnodes = [n for n in dnodes if n.alive]
            if not pnodes:
                return None
        # best remote prefix holder anywhere in the cluster (decode nodes
        # included: post-transfer re-homing parks prefixes there); the
        # prompt is hashed ONCE and the chain reused for every probe — and
        # not at all when nothing is resident or no node could reuse it
        probe = self.prefix_index.has_entries and \
            any(n.supports_prefix_reuse for n in pnodes)
        hashes = self._chain_for(req) if probe else []
        remote_best: Tuple[int, List[int], List[str], Optional[int]] = (0, [], [], None)
        if probe:
            for nid, _ in self.prefix_index.best_nodes(req.prompt_tokens, hashes):
                if nid in self.nodes and self.nodes[nid].alive:
                    hit, blocks, tiers = self.shareable_prefix(nid, req, hashes)
                    if hit > remote_best[0]:
                        remote_best = (hit, blocks, tiers, nid)
        best = None   # (ttft, node, hit, src_node, blocks)
        bs = self.prefix_index.block_size
        for n in pnodes:
            local_hit, local_blocks, local_tiers = (
                self.shareable_prefix(n.node_id, req, hashes)
                if probe and n.supports_prefix_reuse else (0, [], []))
            # DRAM-backed local blocks must be promoted before reuse: price
            # the host->HBM leg so a DRAM-local plan ranks between
            # HBM-remote and recompute (the tier lattice).
            dram_local = sum(1 for t in local_tiers if t != TIER_HBM) * bs
            t = self._ttft_estimate(n, req, hit=local_hit) + \
                tier_fetch_latency(select_route(True, self.target),
                                   0, int(self.model_cost.kv_bytes_per_token
                                          * dram_local), remote=False)
            cand = (t, n, local_hit, n.node_id if local_hit else None, local_blocks)
            if best is None or cand[0] < best[0]:
                best = cand
            r_hit, r_blocks, r_tiers, r_nid = remote_best
            if (n.supports_prefix_reuse and r_nid is not None
                    and r_nid != n.node_id and r_hit > local_hit):
                dram_remote = sum(1 for x in r_tiers if x != TIER_HBM) * bs
                t = self._ttft_estimate(n, req, hit=r_hit) + \
                    self._prefix_fetch_estimate(self.nodes[r_nid], n, r_hit,
                                                dram_tokens=dram_remote)
                if t < best[0]:
                    best = (t, n, r_hit, r_nid, r_blocks)
        _, p_best, hit, src, blocks = best
        req.num_cached_prefix_tokens = hit
        req.prefix_src_node = src
        req.prefix_block_ids = list(blocks)
        d_best = min(dnodes, key=lambda n: self._transfer_estimate(p_best, n, req))
        req.decode_node = d_best.node_id
        p_best.scheduler.enqueue_prefill(req)
        return p_best.node_id, d_best.node_id

    def validate_prefix_plan(self, req: Request) -> bool:
        """Re-check a stamped REMOTE prefix plan against the live index,
        immediately before the runtime fetches.

        One source of truth for staleness (shared by ``PDCluster`` and
        ``ClusterSim``, so sim pricing can never drift from engine
        behavior): the source must be alive and still hold at least the
        stamped hit with the very same leading blocks. Any mismatch clears
        the stamp — the plan degrades to recompute, never to garbage KV —
        and returns False.
        """
        src = self.nodes.get(req.prefix_src_node)
        hit = req.num_cached_prefix_tokens
        ok = src is not None and src.alive and hit > 0
        if ok:
            live, blocks, tiers = self.shareable_prefix(src.node_id, req)
            k = len(req.prefix_block_ids)
            # DRAM entries in the stamped range mean promotion has not run
            # (or failed): the pool->pool fetch cannot address host blocks,
            # so the plan is stale until re-stamped post-promotion.
            ok = (live >= hit
                  and blocks[:k] == list(req.prefix_block_ids)
                  and all(t == TIER_HBM for t in tiers[:k]))
        if not ok:
            req.clear_prefix_plan()
        return ok

    def refresh_prefix_plan(self, req: Request) -> bool:
        """Re-stamp a REMOTE prefix plan from the live index, after the
        source's promote pass may have re-pointed chain entries at fresh
        pool blocks (demote->promote changes physical ids, so the routed
        stamp goes stale even though the KV is present and correct).

        Keeps the plan honest rather than bigger: the refreshed hit is
        capped at the routed hit (pricing already happened), and only the
        leading HBM-backed run is kept. Clears the plan (returns False)
        when nothing shareable remains.
        """
        src = self.nodes.get(req.prefix_src_node)
        if src is None or not src.alive or req.num_cached_prefix_tokens <= 0:
            req.clear_prefix_plan()
            return False
        live, blocks, tiers = self.shareable_prefix(src.node_id, req)
        bs = self.prefix_index.block_size
        nb = 0
        cap = req.num_cached_prefix_tokens // bs
        for b, t in zip(blocks[:cap], tiers[:cap]):
            if t != TIER_HBM:
                break
            nb += 1
        if nb == 0:
            req.clear_prefix_plan()
            return False
        req.num_cached_prefix_tokens = nb * bs
        req.prefix_block_ids = list(blocks[:nb])
        return True

    def rehome_prefix(self, req: Request, node_id: int,
                      blocks: Sequence[int]) -> None:
        """Advertise a prompt's full-block prefix where its KV now lives
        (post-transfer decode node, local handoff, or a fetched copy)."""
        node = self.nodes.get(node_id)
        if node is None or not node.supports_prefix_reuse:
            return
        full_nb = req.prompt_len // self.prefix_index.block_size
        if full_nb and len(blocks) >= full_nb:
            self.record_prefix(node_id, req.prompt_tokens,
                               list(blocks)[:full_nb])

    def _prefix_fetch_estimate(self, src: NodeHandle, dst: NodeHandle,
                               hit_tokens: int, dram_tokens: int = 0) -> float:
        """Latency of pulling a resident prefix src -> dst: ONE fused
        descriptor-table dispatch over the wire, plus (when part of the
        prefix sits in the source's host tier) ONE promote dispatch on the
        HOST_DRAM leg first — the tier-aware fetch price."""
        profile = select_route(src.host_id == dst.host_id, self.target)
        bpt = self.model_cost.kv_bytes_per_token
        return tier_fetch_latency(
            profile,
            hbm_bytes=int(bpt * (hit_tokens - dram_tokens)),
            dram_bytes=int(bpt * dram_tokens), remote=True)

    def _ttft_estimate(self, node: NodeHandle, req: Request,
                       hit: Optional[int] = None) -> float:
        """Queued prefill work + this request's compute, on this node.

        Shared between routing (min-TTFT node pick) and the admission gate
        (predicted TTFT vs SLO) — both price the same queueing model from
        ``core.costmodel.predicted_ttft_s`` over the node's own hardware, so
        a weak card reports longer predicted TTFT for the same backlog.
        ``hit`` overrides the prefix-reuse length (routing evaluates several
        reuse plans per node); default = the node's own resident prefix.

        On a chunked-prefill node the whole-prompt occupancy model is a
        head-of-line fiction — queued prompts interleave in chunks, so a
        short request behind a long one must NOT be charged the long
        prompt's full prefill. ``predicted_chunked_ttft_s`` bounds each
        queued request's interference at the chunk work that can actually
        run before this request's first token (and prices REMAINING tokens,
        not re-counting prefill work already done).
        """
        if hit is None:
            hit, _, _ = self.shareable_prefix(node.node_id, req)
        sched = node.scheduler
        hw = node.hardware
        fpt = self.model_cost.flops_per_token
        # a tp>1 node prefills over tp devices' aggregate FLOPs
        eff = hw.peak_flops * hw.mfu_prefill * node.tp_degree
        new_tokens = req.prompt_len - hit
        if getattr(sched, "chunked_prefill", False):
            chunk = sched.prefill_chunk_tokens or sched.max_batch_tokens
            return predicted_chunked_ttft_s(
                sched.prefill_backlog_tokens(), new_tokens, chunk,
                fpt, eff, hw.step_overhead_s)
        backlog_tokens = sum(r.prompt_len for r in sched.prefill.waiting)
        backlog_tokens += sum(r.prompt_len for r in sched.prefill.running)
        return predicted_ttft_s(
            backlog_tokens * fpt, new_tokens * fpt, eff, hw.step_overhead_s)

    def _transfer_estimate(self, p: NodeHandle, d: NodeHandle, req: Request) -> float:
        """Expected KV transfer latency P->D + a decode-load tiebreak."""
        profile: TransportProfile = select_route(p.host_id == d.host_id, self.target)
        nbytes = self.model_cost.kv_bytes_per_token * (req.prompt_len + 1)
        # cross-degree transfers pay one fused dispatch per overlapping
        # (src_shard, dst_shard) head-range pair, bytes conserved
        calls = sharded_transfer_calls(p.tp_degree, d.tp_degree)
        if self.layer_window > 0:
            # Layer-window streaming: only the wire time that spills past the
            # producing prefill tail is exposed. The hide window is the LAST
            # prefill chunk's compute — the window whose layers the final
            # sub-plans wait on.
            sched = p.scheduler
            tail = req.prompt_len
            if getattr(sched, "chunked_prefill", False):
                tail = min(tail, sched.prefill_chunk_tokens
                           or sched.max_batch_tokens)
            prefill_s = p.hardware.prefill_time(
                tail * self.model_cost.flops_per_token / p.tp_degree)
            latency = estimate_overlapped_transfer_s(
                profile, int(nbytes), self.num_layers, self.layer_window,
                prefill_s, calls_per_window=calls)
        else:
            # FlowKV's segment allocator keeps requests ~1 segment => 1 call
            # per shard pair (1 flat when both sides are unsharded).
            latency = profile.latency(num_calls=calls, num_bytes=int(nbytes))
        load_penalty = node_score(self._scored_status(d), "decode")
        return latency * (1.0 + load_penalty)

    # -- the controller loop ---------------------------------------------------------------
    def step(self, now: float = 0.0) -> str:
        """One controller cycle: sample -> score -> classify -> act."""
        self.cycle += 1
        self.detect_failures(now)
        alive = [n for n in self.nodes.values() if n.alive]
        if not alive:
            return self.regime
        raw = {n.node_id: n.scheduler.sample_status() for n in alive}
        smoothed = {n.node_id: n.scheduler.smoothed_status() for n in alive}
        norm_list = normalize(list(smoothed.values()))
        statuses = dict(zip(smoothed.keys(), norm_list))
        del raw
        # stamp per-node hardware capability so heterogeneous fleets score
        # on one scale (load_score divides pending-work terms by capability)
        caps = self._capabilities()
        statuses = {nid: (s.with_capability(*caps[nid]) if nid in caps else s)
                    for nid, s in statuses.items()}
        # like capability_*, the mesh degrees are constants re-stamped AFTER
        # normalize() (which rebuilds statuses from STATUS_FIELDS only)
        statuses = {nid: s.with_sharding(self.nodes[nid].tp_degree,
                                         self.nodes[nid].ep_degree)
                    for nid, s in statuses.items()}
        cp, cd = cluster_scores(
            statuses,
            [n.node_id for n in self.prefill_nodes()],
            [n.node_id for n in self.decode_nodes()],
        )
        regime = classify_regime(cp, cd, self.thresholds)
        if regime != self.regime:
            self._log("regime", f"{self.regime} -> {regime} (C^p={cp:.3f}, C^d={cd:.3f})")
        self.regime = regime
        act = self.actions_enabled   # passive controllers observe, never act

        if regime == "imbalanced":
            if act:
                self._handle_imbalance(statuses, cp, cd)
            self._extreme_streak = 0
            self._low_streak = 0
            self._normal_streak = 0
        elif regime == "extreme":
            self._extreme_streak += 1
            self._low_streak = 0
            self._normal_streak = 0
            if self._extreme_streak >= self.thresholds.scale_patience:
                if act:
                    self._scale_up(cp, cd)
                self._extreme_streak = 0
        else:
            self._normal_streak += 1
            if act:
                self._flip_back(statuses)
            self._extreme_streak = 0
            if cp < 0.05 and cd < 0.05:
                self._low_streak += 1
                if self._low_streak >= 4 * self.thresholds.scale_patience:
                    if act:
                        self._scale_down()
                    self._low_streak = 0
            else:
                self._low_streak = 0
        self._drain_deferred()
        self.reroute_retries()
        return regime

    # -- imbalanced regime: role switching (App. B.1) ------------------------------------------
    def _handle_imbalance(self, statuses: Dict[int, NodeStatus], cp: float, cd: float) -> None:
        hot_role = "prefill" if cp >= cd else "decode"
        cold_role = "decode" if hot_role == "prefill" else "prefill"
        idle = [
            n for n in self.nodes.values()
            if n.alive and n.role == cold_role
            and node_score(statuses[n.node_id], cold_role) < self.thresholds.idle
        ]
        # Capability-weighted skew: on a heterogeneous fleet, borrow the
        # candidate best SUITED to the hot role first — compute-rich cards
        # for a prefill burst, bandwidth/memory-rich cards for a decode
        # burst — so a flip adds the most capacity per node moved.
        caps = self._capabilities()

        def suitability(n: NodeHandle) -> float:
            c, m, kv = caps.get(n.node_id, (1.0, 1.0, 1.0))
            return c if hot_role == "prefill" else 0.5 * (m + kv)

        idle.sort(key=suitability, reverse=True)
        hot_score, cold_score = (cp, cd) if hot_role == "prefill" else (cd, cp)
        for node in idle:
            if self.role_flip:
                if self.cycle < node.switched_until_cycle:
                    continue   # residency: a fresh flip may not be reversed yet
                # Full reassignment needs a decisive skew (flipping idle nodes
                # into the hot role dilutes its mean score, so a lukewarm
                # near-tie would otherwise ping-pong the hot side each cycle)
                # and must never strand the cold role at zero nodes.
                remaining = [n for n in self.nodes.values()
                             if n.alive and n.role == cold_role]
                if hot_score - cold_score > self.thresholds.idle and len(remaining) > 1:
                    if node.home_role is None:
                        node.home_role = cold_role
                    self.set_role(node.node_id, hot_role)
                    # minimum residency in the borrowed role (anti-thrash)
                    node.switched_until_cycle = self.cycle + self.role_switch_cycles
                    continue
            node.scheduler.set_priority(hot_role, cycles=self.role_switch_cycles)
            node.switched_until_cycle = self.cycle + self.role_switch_cycles
            self._log("role_switch",
                      f"node {node.node_id} ({cold_role}) -> priority {hot_role} "
                      f"for {self.role_switch_cycles} cycles")

    def _flip_back(self, statuses: Dict[int, NodeStatus]) -> None:
        """Normal regime: return flipped nodes to their home role.

        Guarded against thrash — flipping idle nodes INTO the hot role
        dilutes that role's mean score, which alone would read as "back to
        normal". A node only reverts after (a) a sustained normal streak,
        (b) its minimum residency in the borrowed role elapsed, and (c) it
        is idle in the borrowed role (no longer absorbing the burst).
        """
        if self._normal_streak < self.role_switch_cycles:
            return
        for node in self.nodes.values():
            if (node.alive and node.home_role is not None
                    and node.role != node.home_role
                    and self.cycle >= node.switched_until_cycle
                    and node_score(statuses.get(node.node_id, NodeStatus()),
                                   node.role) < self.thresholds.idle):
                # same stranding guard as the flip itself: never revert the
                # last node of its CURRENT role (a sequence of flips can
                # otherwise leave the cluster 100% one role)
                peers = [m for m in self.nodes.values()
                         if m.alive and m.role == node.role]
                if len(peers) <= 1:
                    continue
                home = node.home_role
                node.home_role = None
                self.set_role(node.node_id, home)

    # -- extreme regime: elastic scaling (App. B.1) ----------------------------------------------
    def _scale_up(self, cp: float, cd: float) -> None:
        if self.node_factory is None:
            self._log("scale_up", "requested but no node_factory configured")
            return
        role = "prefill" if cp >= cd else "decode"
        node = self.node_factory(role)
        self.register_node(node)
        self._log("scale_up", f"added node {node.node_id} as {role}")

    def _scale_down(self) -> None:
        # Remove the least-loaded node of the more numerous role, if >1 remain.
        for role_nodes in (self.prefill_nodes(), self.decode_nodes()):
            if len(role_nodes) > 1:
                victim = min(role_nodes,
                             key=lambda n: node_score(self._scored_status(n), n.role))
                sched = victim.scheduler
                busy = (sched.prefill.running or sched.decode.running
                        or sched.prefill.sending)
                if busy:
                    continue
                victim.alive = False
                self.retry_queue.extend(victim.scheduler.drain_for_failure())
                self.prefix_index.evict_node(victim.node_id)
                self._log("scale_down", f"removed idle node {victim.node_id} ({victim.role})")
                return

    # -- misc ------------------------------------------------------------------------------------
    def _log(self, kind: str, detail: str) -> None:
        self.events.append(ControllerEvent(self.cycle, kind, detail))

    def record_prefix(self, node_id: int, tokens: Sequence[int],
                      block_ids: Optional[Sequence[int]] = None) -> None:
        """Advertise a prompt's KV as resident on a node.

        ``block_ids`` (one per full block of ``tokens``) is what makes the
        entry shareable; without it the entry only biases routing estimates
        and the data plane never claims reuse from it.
        """
        self.prefix_index.insert(node_id, tokens, block_ids)
