"""PD-disaggregated cluster runtime (real compute). Port of
``repro/serving/cluster.py``; defaults to the H100 hardware profile and the
GPU transport routes (IPC inside a host, NCCL across).

Wires together: NodeEngines (role-flexible P/D nodes) + GlobalController
(routing, regimes, role lifecycle, failover) + the TransferBackend registry
(``core/transfer.py``: paged FlowKV transfer between node pools, whole-state
transfer for ssm/hybrid/encdec, or any registered third-party transport).

The runtime is the *correctness* half of the reproduction: disaggregated
generation must be token-identical to monolithic generation on one engine.
Fault tolerance: ``kill_node`` simulates a node death mid-flight; the
controller's heartbeat scan drains and re-routes its requests.
``checkpoint``/``restore`` round-trip the full cluster state
(``serving/checkpoint.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.costmodel import layer_window_overlap, select_route
from repro_torch.core.scheduler.global_controller import (AdmissionDecision,
                                                    AdmissionPolicy,
                                                    GlobalController, ModelCost,
                                                    NodeHandle)
from repro_torch.core.transfer import (backend_for_engine, land_plan, pool_transfer_engine,
                                       verify_pool_transfer)
from repro_torch.faults import as_injector
from repro_torch.models.common import ModelConfig
from repro_torch.serving.engine import NodeEngine
from repro_torch.serving.host_tier import TierManager
from repro_torch.serving.request import Request, RequestState
from repro_torch.sim.hardware import H100, HardwareProfile


@dataclasses.dataclass
class TransferRecord:
    request_id: int
    schedule: str
    num_calls: int
    num_bytes: int
    est_latency_s: float        # EXPOSED latency (post-prefill wire time)
    num_dispatches: int = 0
    kind: str = "kv"            # "kv" (P->D cache move) | "prefix_fetch"
    # wire time hidden behind the producer's prefill compute by layer-window
    # streaming (0.0 on the unoverlapped path); est_latency_s + hidden_s is
    # the total time on the wire
    hidden_s: float = 0.0
    num_windows: int = 1
    src_node: int = -1
    dst_node: int = -1
    # "ok" | "aborted_dst_dead" (dst died mid-stream; retried to a new dst
    # next cycle) | "degraded" (every retry failed; recomputed on the decode
    # node). Latency aggregates only count "ok" records.
    status: str = "ok"
    retries: int = 0            # failed attempts absorbed by THIS transfer


class PDCluster:
    def __init__(self, cfg: ModelConfig, params, *, num_prefill: int = 1,
                 num_decode: int = 1, num_blocks: int = 256,
                 allocator: str = "flowkv", transfer_schedule: str = "flowkv",
                 hardware: Union[HardwareProfile,
                                 Dict[int, HardwareProfile]] = H100,
                 target: str = "gpu",
                 max_batch_tokens: int = 2048, hosts: Optional[Dict[int, int]] = None,
                 role_flip: bool = False, paged_decode: str = "auto",
                 admission: Optional[AdmissionPolicy] = None,
                 prefix_reuse: bool = True, tracer=None,
                 host_tier_blocks: int = 0,
                 chunked_prefill: bool = True,
                 prefill_chunk_tokens: Optional[int] = None,
                 layer_window: int = 0,
                 faults=None,
                 heartbeat_timeout_cycles: float = 10.0,
                 transfer_max_retries: int = 3,
                 transfer_backoff_cycles: float = 0.5,
                 tp_degrees: Optional[Dict[int, int]] = None,
                 device=None):
        self.cfg = cfg
        # Per-node mesh-parallel degree ({node_id: tp}, missing ids -> 1):
        # a heterogeneous fleet runs e.g. TP=2 prefill nodes feeding TP=4
        # decode nodes; the transfer plane lowers each cross-degree move to
        # one K1 launch per overlapping (src_shard, dst_shard) pair.
        self.tp_degrees = dict(tp_degrees or {})
        self.transfer_schedule = transfer_schedule
        self.target = target
        # Fault plane: an optional repro_torch.faults.FaultInjector (or spec list /
        # capture meta dict) drives deterministic chaos — node crashes applied
        # at the top of step(), transfer fail/corrupt verdicts per attempt,
        # bandwidth degradation, heartbeat suppression. None = no faults.
        self.faults = as_injector(faults)
        # Transfer hardening: every fused dispatch is checksum-verified; a
        # failed/corrupt attempt retries with exponential backoff (priced
        # into the transfer's exposed latency), and after
        # transfer_max_retries + 1 failed attempts the request degrades to
        # recompute-on-the-decode-node instead of wedging the sending queue.
        self.transfer_max_retries = transfer_max_retries
        self.transfer_backoff_cycles = transfer_backoff_cycles
        # Layerwise transfer/compute overlap: layer_window > 0 streams each
        # P->D transfer as ceil(L / layer_window) per-layer-window sub-plans
        # (own fused dispatch each), so completed layers' KV is on the wire
        # while later layers still prefill. 0 = classic one-plan transfer.
        self.layer_window = layer_window
        # Optional repro_torch.obs.tracing.SpanRecorder (also settable post-hoc
        # via repro_torch.obs.tracing.attach_tracer): the cluster emits queue /
        # transfer / decode / prefix_fetch spans, engines emit prefill,
        # the controller emits admission.
        self.tracer = tracer
        # prefix_reuse=False disables the reuse DATA PLANE (no recording, no
        # sharing, no fetches) — the A/B switch the token-identity tests and
        # benchmarks/prefix_reuse.py flip. Invalidation stays wired either
        # way; an empty index just never matches.
        self.prefix_reuse = prefix_reuse
        # host_tier_blocks > 0 adds a per-node host-DRAM tier behind the
        # pool: cold index-backed blocks demote there under capacity
        # pressure and promote back (one fused dispatch each way) on re-use.
        self.host_tier_blocks = host_tier_blocks
        self.tiers: Dict[int, TierManager] = {}
        self.engines: Dict[int, NodeEngine] = {}
        model_cost = ModelCost(
            flops_per_token=2.0 * cfg.active_params(),
            kv_bytes_per_token=float(cfg.kv_bytes_per_token() or 1024),
            weight_bytes=2.0 * cfg.num_params(),
            state_bytes_per_request=float(cfg.state_slot_bytes()),
        )
        n_attn = cfg.num_attention_layers() or cfg.num_layers
        self.controller = GlobalController(model_cost, cfg.block_size, target=target,
                                           role_flip=role_flip,
                                           admission=admission,
                                           layer_window=layer_window,
                                           num_layers=n_attn,
                                           heartbeat_timeout=heartbeat_timeout_cycles)
        self.controller.tracer = tracer
        self.clock = 0.0
        self.submitted = 0
        self._dead: set = set()      # killed engines stop heartbeating/working
        self.transfers: List[TransferRecord] = []
        self.finished: List[Request] = []
        self.cancelled: List[Request] = []
        self.rejected: List[Request] = []
        # fleet-level fault counters (stats())
        self.fault_kills = 0
        self.transfer_retry_count = 0
        self.degraded_to_recompute = 0
        self.recoveries = 0

        for i in range(num_prefill + num_decode):
            role = "prefill" if i < num_prefill else "decode"
            engine = NodeEngine(i, cfg, params, num_blocks=num_blocks,
                                allocator=allocator, max_batch_tokens=max_batch_tokens,
                                paged_decode=paged_decode,
                                chunked_prefill=chunked_prefill,
                                prefill_chunk_tokens=prefill_chunk_tokens,
                                tp_degree=self.tp_degrees.get(i, 1), device=device)
            engine.tracer = tracer
            self.engines[i] = engine
            host = (hosts or {}).get(i, i)
            # heterogeneous fleets: hardware may be one profile for every
            # node or a {node_id: profile} map (missing ids get H100)
            hw = hardware.get(i, H100) if isinstance(hardware, dict) \
                else hardware
            reuse = prefix_reuse and engine.supports_prefix_reuse
            self.controller.register_node(NodeHandle(
                node_id=i, role=role, host_id=host, hardware=hw,
                scheduler=engine.scheduler, supports_prefix_reuse=reuse,
                tp_degree=engine.tp_degree, ep_degree=engine.ep_degree))
            # residency honesty: ANY path that physically frees blocks
            # (transfer done, decode finish, cancel, preemption, teardown)
            # drops the freed blocks' index entries on this node
            engine.scheduler.bm.on_free = \
                (lambda blocks, nid=i:
                 self.controller.prefix_index.invalidate_blocks(nid, blocks))
            if reuse:
                engine.scheduler.resolve_prefix = self._make_resolver(engine)
            # the host tier stays tp=1-only: demotion and promotion move
            # whole-payload pages, as in the reference
            if reuse and host_tier_blocks > 0 and engine.tp_degree == 1:
                self.tiers[i] = engine.tier = TierManager(
                    i, engine.scheduler.bm, self.controller.prefix_index,
                    engine.kv.spec, host_tier_blocks, kv=engine.kv,
                    schedule=transfer_schedule,
                    get_tracer=lambda: self.tracer,
                    get_clock=lambda: self.clock).attach()

    def _make_resolver(self, engine: NodeEngine):
        """Admission-time prefix resolution for one node (scheduler hook):
        the shared controller helper re-validates the routing-time stamp
        against the LIVE index and this node's block liveness."""
        nid, bm = engine.node_id, engine.scheduler.bm
        return lambda req: self.controller.resolve_local_prefix(
            nid, req, bm.block_alive)

    # -- request entry ------------------------------------------------------------
    def submit(self, req: Request) -> AdmissionDecision:
        """Admission gate + routing. With no AdmissionPolicy every request
        is admitted (legacy behavior); with one, the decision may be
        "deferred" (parked controller-side, admitted as load drains) or
        "rejected" (terminal REJECTED state + retry-after hint)."""
        if req.arrival_wall is None:
            req.arrival_wall = time.monotonic()
        decision = self.controller.submit_request(req)
        if decision.admitted and decision.route is None:
            raise RuntimeError("no alive nodes to route to")
        self.submitted += 1
        self._collect_rejected()
        return decision

    def _collect_rejected(self) -> None:
        for req in self.controller.take_rejected():
            req.finish_time = self.clock
            req.finish_wall = time.monotonic()
            self.rejected.append(req)

    # -- the FlowKV transfer (P pool -> D pool) -------------------------------------
    def _transfer(self, req: Request) -> None:
        """Move one request's cache P->D via the TransferBackend registry.

        The backend (paged vs state vs anything third-party) is resolved
        from the source engine — this method never branches on the cache
        transport itself.
        """
        src = self.engines[req.prefill_node]
        # Failover re-target: the decode node chosen at routing time may
        # have died while the request prefilled. Re-pick BEFORE planning so
        # the dst-side registration lands on a live pool.
        if req.decode_node in self._dead or \
                not self.controller.nodes[req.decode_node].alive:
            nd = self._pick_decode_node(exclude={req.decode_node})
            req.decode_node = nd if nd is not None else src.node_id
        dst = self.engines[req.decode_node]
        if src is not dst and not dst.can_accept_transfer(req):
            return      # no state slot free on dst: stays SENDING, retried next cycle
        req.transfer_start = self.clock
        req.transfer_start_wall = time.monotonic()
        if src is dst:
            # Role-flexible node serving both stages: the cache is already
            # in this node's pool — hand off locally, keep the blocks.
            req.transfer_end = self.clock
            req.transfer_end_wall = req.transfer_start_wall
            req.transfer_calls = req.transfer_dispatches = 0
            src.scheduler.sending_done(req, free=False)
            dst.scheduler.enqueue_decode(req)
            self._rehome_prefix(req, src.node_id,
                                src.scheduler.bm.get(req.request_id))
            if self.tracer is not None:
                self.tracer.emit(
                    req.request_id, "transfer",
                    start_cycle=req.transfer_start, end_cycle=req.transfer_end,
                    start_wall_s=req.transfer_start_wall,
                    end_wall_s=req.transfer_end_wall, node_id=src.node_id,
                    attrs={"schedule": "local", "calls": 0, "dispatches": 0,
                           "bytes": 0, "est_latency_s": 0.0})
            return
        profile = select_route(
            self.controller.nodes[src.node_id].host_id ==
            self.controller.nodes[dst.node_id].host_id, self.target)
        backend = backend_for_engine(src, self.transfer_schedule)
        job = backend.plan(req, src, dst)
        hidden = 0.0
        windows = 1
        retries_before = req.transfer_retries
        if self.layer_window > 0 and job.plan is not None and not job.state_bytes and \
                job.plan.num_layers > self.layer_window:
            outcome, latency, hidden = self._transfer_windowed(
                req, src, dst, job, profile)
            windows = -(-job.plan.num_layers // self.layer_window)
            if outcome != "ok":
                self._abort_transfer(req, src, dst, job, outcome,
                                     req.transfer_retries - retries_before)
                return
        else:
            penalty = self._attempt_unit(
                req, src, dst, lambda: backend.execute(job, src, dst),
                job.plan)
            if penalty is None:
                self._abort_transfer(req, src, dst, job, "exhausted",
                                     req.transfer_retries - retries_before)
                return
            latency = backend.price(job, profile) * self._bandwidth_factor() \
                + penalty
        self.transfers.append(TransferRecord(
            req.request_id, job.schedule, job.num_calls, job.num_bytes, latency,
            job.num_dispatches, hidden_s=hidden, num_windows=windows,
            src_node=src.node_id, dst_node=dst.node_id,
            retries=req.transfer_retries - retries_before))
        req.transfer_end = self.clock + latency
        req.transfer_end_wall = time.monotonic()
        req.transfer_calls = job.num_calls
        req.transfer_dispatches = job.num_dispatches
        if self.tracer is not None:
            self.tracer.emit(
                req.request_id, "transfer",
                start_cycle=req.transfer_start, end_cycle=req.transfer_end,
                start_wall_s=req.transfer_start_wall,
                end_wall_s=req.transfer_end_wall, node_id=src.node_id,
                attrs={"schedule": job.schedule, "calls": job.num_calls,
                       "dispatches": job.num_dispatches,
                       "bytes": job.num_bytes, "page_bytes": job.num_bytes - job.state_bytes,
                       "state_bytes": job.state_bytes, "est_latency_s": latency,
                       "hidden_s": hidden, "windows": windows,
                       "dst_node": dst.node_id,
                       "src_tp": src.tp_degree, "dst_tp": dst.tp_degree,
                       "retries": req.transfer_retries - retries_before})
        # The prompt's KV now lives on the DECODE node; sending_done below
        # frees the prefill-side blocks (and invalidates their entries), so
        # the index entry is re-homed to where the KV actually is.
        self._rehome_prefix(req, dst.node_id, list(job.dst_blocks))
        src.scheduler.sending_done(req)
        src.drop_state(req.request_id)
        dst.scheduler.enqueue_decode(req)

    # -- transfer hardening (retry / integrity / degradation) -------------------------
    def _bandwidth_factor(self) -> float:
        return self.faults.bandwidth_factor(self.clock) \
            if self.faults is not None else 1.0

    def _pick_decode_node(self, exclude=()) -> Optional[int]:
        """Least-loaded live decode node (any live node as fallback)."""
        cands = [n for n in self.controller.nodes.values()
                 if n.alive and n.node_id not in self._dead
                 and n.node_id not in exclude]
        if not cands:
            return None
        decode = [n for n in cands if n.role == "decode"] or cands
        return min(decode,
                   key=lambda n: len(n.scheduler.decode.running)).node_id

    def _attempt_unit(self, req: Request, src: NodeEngine, dst: NodeEngine,
                      execute, plan) -> Optional[float]:
        """Run one transfer unit (a full plan, or one layer-window sub-plan)
        under the fault injector with post-dispatch integrity checking.

        Every executed dispatch is checksum-verified (src pages vs dst pages
        through the plan's descriptor table); a failed or corrupt attempt
        retries with exponential backoff. Returns the latency penalty the
        retries accrued, or None when all ``transfer_max_retries + 1``
        attempts failed (caller degrades to recompute). An injected "fail"
        drops the attempt before any bytes move; an injected "corrupt" lands
        the payload then flips one destination element, so the checksum —
        not the injector — is what catches it, and the clean retry's
        re-execution overwrites (repairs) the damage.
        """
        penalty = 0.0
        verifiable = (plan is not None and src.kv is not None
                      and dst.kv is not None)
        for attempt in range(self.transfer_max_retries + 1):
            fault = self.faults.transfer_attempt(self.clock) \
                if self.faults is not None else None
            corrupting = fault == "corrupt" and verifiable
            if fault is not None and not corrupting:
                ok = False          # dropped on the wire: nothing reached dst
            else:
                execute()
                if corrupting:
                    self._corrupt_dst(dst, plan)
                ok = verify_pool_transfer(plan, src.kv, dst.kv) \
                    if verifiable else True
            if ok:
                return penalty
            req.transfer_retries += 1
            self.transfer_retry_count += 1
            backoff = self.transfer_backoff_cycles * (2.0 ** attempt)
            penalty += backoff
            if self.tracer is not None:
                wall = self.tracer.wall()
                self.tracer.emit(
                    req.request_id, "transfer_retry",
                    start_cycle=self.clock, end_cycle=self.clock + backoff,
                    start_wall_s=wall, end_wall_s=wall, node_id=src.node_id,
                    attrs={"attempt": attempt, "fault": fault or "checksum",
                           "backoff_s": backoff})
        return None

    def _corrupt_dst(self, dst: NodeEngine, plan) -> None:
        """Injected in-flight corruption: flip one element of the first page
        this plan wrote on the destination (so the checksum genuinely
        mismatches against the source pages)."""
        table = plan.to_descriptors()
        if len(table) == 0:
            return
        # sharded pool: flip an element in shard 0's slice (the per-pair
        # verify covering (src?, dst_shard=0) must catch it)
        kv = dst.kv.shards[0] if hasattr(dst.kv, "shards") else dst.kv
        spec = kv.spec
        pid = int(table.page_ids(spec, "dst")[0])
        kv.pool.view(-1, spec.payload)[pid, 0] += 1.0   # in place

    def _abort_transfer(self, req: Request, src: NodeEngine, dst: NodeEngine,
                        job, reason: str, retries: int) -> None:
        """A transfer could not complete. Two cases:

        * ``dst_dead`` — the destination died mid-stream. Partial dst state
          is already freed; the request STAYS in the sending queue, so next
          cycle's drain re-picks a live destination and re-plans (the source
          still holds the full KV).
        * ``exhausted`` — every retry of some dispatch failed. Degrade to
          recompute: drop both sides' blocks and re-prefill (token-exact)
          on the decode node, pricing recovery as real prefill compute.
        """
        status = "aborted_dst_dead" if reason == "dst_dead" else "degraded"
        self.transfers.append(TransferRecord(
            req.request_id, job.schedule, job.num_calls, job.num_bytes, 0.0,
            job.num_dispatches, src_node=src.node_id, dst_node=dst.node_id,
            status=status, retries=retries))
        if reason == "dst_dead":
            if dst.scheduler.bm.owns(req.request_id):
                dst.scheduler.bm.free(req.request_id)
            dst.drop_state(req.request_id)
            return
        self._degrade_to_recompute(req, src, dst)

    def _degrade_to_recompute(self, req: Request, src: NodeEngine,
                              dst: NodeEngine) -> None:
        """Retry-exhausted transfer: stop moving KV, recompute it instead.

        Frees the partially-written dst registration AND the src blocks,
        then re-enqueues the request as a fresh prefill on the decode node
        (or the source if the destination is gone) — recovery re-prefills
        prompt + already-emitted tokens teacher-forced, so the stream stays
        token-exact, and the cost is honest prefill compute on that node.
        """
        if dst.scheduler.bm.owns(req.request_id):
            dst.scheduler.bm.free(req.request_id)
        dst.drop_state(req.request_id)
        src.scheduler.sending_done(req, free=True)
        # the state path's source still holds the state that never moved:
        # drop it too (the reference keeps it for good; ROADMAP queue 3)
        src.drop_state(req.request_id)
        self.degraded_to_recompute += 1
        target = dst if (dst.node_id not in self._dead and
                         self.controller.nodes[dst.node_id].alive) else src
        self.controller._stamp_failure(req, self.clock, target.node_id,
                                       "transfer_retries_exhausted")
        req.reset_for_retry()
        req.prefill_node = target.node_id
        req.decode_node = target.node_id
        target.scheduler.enqueue_prefill(req)

    def _finish_recovery(self, req: Request, node_id: int) -> None:
        """Close the failure→re-prefilled window (the request is live again,
        its replayed tokens recomputed token-exactly): accumulate the
        failover cost on both clocks and emit the ``recovery`` span."""
        req.recovery_s += self.clock - req.recovery_start
        wall = time.monotonic()
        if req.recovery_start_wall is not None:
            req.recovery_wall_s = (req.recovery_wall_s or 0.0) + \
                (wall - req.recovery_start_wall)
        req.recoveries += 1
        self.recoveries += 1
        if self.tracer is not None:
            self.tracer.emit(
                req.request_id, "recovery",
                start_cycle=req.recovery_start, end_cycle=self.clock,
                start_wall_s=req.recovery_start_wall, end_wall_s=wall,
                node_id=node_id,
                attrs={"replayed_tokens": req.replayed_tokens,
                       "retries": req.retries})
        req.recovery_start = None
        req.recovery_start_wall = None

    def _prefill_tail_s(self, req: Request) -> float:
        """Compute window available for hiding transfer: the duration of
        this request's FINAL prefill chunk on its prefill node (the pass
        whose early layers' KV the first sub-plans ship). Chunking shrinks
        it — the real trade-off: smaller chunks cut queueing TTFT but leave
        less compute to hide wire time behind."""
        tokens = req.last_prefill_chunk_tokens or req.prompt_len
        hw = self.controller.nodes[req.prefill_node].hardware
        return hw.prefill_time(
            tokens * self.controller.model_cost.flops_per_token)

    def _transfer_windowed(self, req: Request, src: NodeEngine,
                           dst: NodeEngine, job, profile
                           ) -> Tuple[str, float, float]:
        """Execute one P->D transfer as per-layer-window sub-plans (each its
        own fused descriptor-table dispatch) and price the pipeline:
        window w goes on the wire as soon as its layers finish prefilling,
        so only the spill past the end of prefill is exposed latency.
        Returns ``(status, exposed_s, hidden_s)``; status "dst_dead" means
        the destination died between sub-plans (its partially-written blocks
        are freed here — the kill-mid-transfer leak class), "exhausted"
        means some sub-plan failed every retry. Mutates ``job``'s
        call/dispatch counts to the windowed totals (more, smaller calls —
        the cost side of overlap, priced honestly; retried dispatches
        count too)."""
        subs = job.plan.split_layer_windows(self.layer_window)
        engine_t = pool_transfer_engine(src.kv, dst.kv)
        bw = self._bandwidth_factor()
        lats = []
        penalty = 0.0
        for sub in subs:
            if req.decode_node in self._dead or \
                    not self.controller.nodes[dst.node_id].alive:
                # mid-stream death: windows already imported landed in a
                # dead pool — drop the partial registration so those blocks
                # are neither billed nor ever advertised as resident
                if dst.scheduler.bm.owns(req.request_id):
                    dst.scheduler.bm.free(req.request_id)
                return "dst_dead", 0.0, 0.0
            unit = lambda s=sub: land_plan(engine_t, s, src.kv, dst.kv)
            p = self._attempt_unit(req, src, dst, unit, sub)
            if p is None:
                return "exhausted", 0.0, 0.0
            penalty += p
            lats.append(sub.latency(profile) * bw)
        job.num_dispatches = engine_t.num_dispatches
        job.num_calls = sum(sub.num_calls for sub in subs)
        L = job.plan.num_layers
        prefill_s = self._prefill_tail_s(req)
        ends = [sub.layer_span[1] for sub in subs]
        exposed, hidden = layer_window_overlap(lats, ends, L, prefill_s)
        if self.tracer is not None:
            # Per-window spans on the notional [clock - prefill_s, clock]
            # prefill tail: windows that ran during compute visibly precede
            # the parent transfer span's start — that's the overlap.
            t0 = self.clock - prefill_s
            finish = 0.0
            wall = time.monotonic()
            for sub, lat in zip(subs, lats):
                lo, hi = sub.layer_span
                start = max(finish, prefill_s * hi / L)
                finish = start + lat
                self.tracer.emit(
                    req.request_id, "transfer_layer_window",
                    start_cycle=t0 + start, end_cycle=t0 + finish,
                    start_wall_s=wall, end_wall_s=wall, node_id=src.node_id,
                    attrs={"layer_lo": lo, "layer_hi": hi,
                           "bytes": sub.total_bytes, "est_latency_s": lat,
                           "hidden": finish <= prefill_s})
        return "ok", exposed + penalty, hidden

    def _rehome_prefix(self, req: Request, node_id: int,
                       blocks: List[int]) -> None:
        """Advertise a prompt's full-block prefix as resident on ``node_id``."""
        if self.prefix_reuse:
            self.controller.rehome_prefix(req, node_id, blocks)

    # -- tier promotion (host DRAM -> pool, ahead of reuse) --------------------------
    def _promote_pending(self, engine: NodeEngine) -> None:
        """Lift the head-of-line waiting request's LOCAL host-tier prefix
        back into the pool before this node schedules, so admission-time
        resolution sees HBM blocks. Head-of-line only, like the remote
        fetch pass — and when promotion cannot run (pool genuinely full),
        ``resolve_local_prefix`` truncates at the first dram entry and the
        request recomputes that tail instead of deadlocking."""
        tm = self.tiers.get(engine.node_id)
        if tm is None or not engine.scheduler.prefill.waiting:
            return
        req = engine.scheduler.prefill.waiting[0]
        if engine.scheduler.bm.owns(req.request_id):
            return
        if req.prefix_src_node is not None and \
                req.prefix_src_node != engine.node_id:
            return   # remote plan: promotion happens at the SOURCE node
        tm.promote_match(req.prompt_tokens, trace_id=req.request_id)

    # -- the prefix fetch (remote resident prefix -> local pool) ---------------------
    def _fetch_pending_prefixes(self, engine: NodeEngine) -> None:
        """Execute the remote-prefix plan for this node's next admission.

        Runs each cycle BEFORE the node schedules, so a fetched prefix is in
        the pool by the time admission shares it into the block table. Only
        the HEAD of the waiting queue fetches — admission is head-of-line,
        and letting queue-tail requests grab prefix blocks early could
        starve a large head request of the free blocks it needs to ever
        admit (fetched blocks only free on admission progress)."""
        if not engine.scheduler.prefill.waiting:
            return
        req = engine.scheduler.prefill.waiting[0]
        src = req.prefix_src_node
        if src is None or src == engine.node_id or \
                engine.scheduler.bm.owns(req.request_id):
            return
        self._fetch_prefix(engine, req)

    def _fetch_prefix(self, engine: NodeEngine, req: Request) -> None:
        """Pull a remote resident prefix into this node's pool as ONE fused
        descriptor-table dispatch (the same data plane as a P->D transfer),
        priced by ``core.costmodel``. On any staleness — source died, blocks
        freed, pool full — the plan degrades to recompute (stamp cleared;
        admission re-resolves locally)."""
        src_id = req.prefix_src_node
        src = self.engines.get(src_id)
        if src is None or src_id in self._dead:
            # runtime knows the engine is gone before the controller's
            # heartbeat scan does — clear the plan (recompute)
            req.clear_prefix_plan()
            return
        # Source-side promotion: any of the plan's blocks that demoted to
        # the source's host tier come back to pool blocks first (one fused
        # host->HBM dispatch), then the stamp is refreshed — demote->promote
        # changes physical ids, so the routed block list is stale even
        # though the KV is intact.
        src_tm = self.tiers.get(src_id)
        if src_tm is not None and \
                src_tm.promote_match(req.prompt_tokens,
                                     trace_id=req.request_id):
            if not self.controller.refresh_prefix_plan(req):
                return   # nothing shareable survived promotion
        if not self.controller.validate_prefix_plan(req):
            return   # stale plan cleared by the shared validator
        hit = req.num_cached_prefix_tokens
        bm = engine.scheduler.bm
        if not bm.can_allocate(hit):
            return   # destination pool full — retry next cycle
        dst_blocks = bm.allocate(req.request_id, hit)
        engine_t = pool_transfer_engine(src.kv, engine.kv)
        plan = engine_t.plan(self.transfer_schedule, req.prefix_block_ids, dst_blocks)
        land_plan(engine_t, plan, src.kv, engine.kv)
        profile = select_route(
            self.controller.nodes[src_id].host_id ==
            self.controller.nodes[engine.node_id].host_id, self.target)
        latency = plan.latency(profile)
        self.transfers.append(TransferRecord(
            req.request_id, plan.schedule, plan.num_calls, plan.total_bytes,
            latency, plan.num_dispatches, kind="prefix_fetch"))
        req.prefix_fetch_dispatches = plan.num_dispatches
        if self.tracer is not None:
            wall = self.tracer.wall()
            self.tracer.emit(
                req.request_id, "prefix_fetch",
                start_cycle=self.clock, end_cycle=self.clock + latency,
                start_wall_s=wall, end_wall_s=wall,
                node_id=engine.node_id,
                attrs={"src_node": src_id, "tokens": hit,
                       "dispatches": plan.num_dispatches,
                       "bytes": plan.total_bytes, "est_latency_s": latency})
        # the fetched copy is itself resident, shareable KV on this node
        self.controller.record_prefix(engine.node_id,
                                      req.prompt_tokens[:hit], dst_blocks)
        req.prefix_src_node = engine.node_id
        req.prefix_block_ids = dst_blocks

    # -- main loop -------------------------------------------------------------------
    def step(self) -> None:
        """One cluster cycle: faults due + controller + every node + transfers."""
        self.clock += 1.0
        if self.faults is not None:
            for spec in self.faults.due(self.clock):
                if spec.node_id not in self._dead:
                    self.kill_node(spec.node_id)
        for nid, engine in self.engines.items():
            if nid in self._dead or not self.controller.nodes[nid].alive:
                continue
            if self.faults is None or \
                    not self.faults.heartbeat_suppressed(nid, self.clock):
                self.controller.heartbeat(nid, self.clock)
            if self.prefix_reuse and engine.supports_prefix_reuse:
                self._promote_pending(engine)
                self._fetch_pending_prefixes(engine)
            # engine stamps prefill_start / first_token_time (the first token
            # is emitted by prefill itself, not by the transfer)
            pre_done, finished = engine.step(now=self.clock)
            for req in pre_done:
                req.prefill_end = self.clock
                if req.recovery_start is not None:
                    # re-prefill after a failure completed: the request is
                    # caught up (replayed tokens recomputed token-exactly)
                    self._finish_recovery(req, nid)
                if self.tracer is not None:
                    # queue span closes when prefill started (stamped by the
                    # engine); emitted here because the engine does not see
                    # the request until it leaves the waiting queue
                    self.tracer.emit(
                        req.request_id, "queue",
                        start_cycle=req.arrival_time,
                        end_cycle=req.prefill_start,
                        start_wall_s=req.arrival_wall,
                        end_wall_s=req.prefill_start_wall, node_id=nid,
                        attrs={"defers": req.admission_defers,
                               "retries": req.retries})
                engine.scheduler.mark_sending(req)
                # NOTE: the prefix is recorded where the KV ends up (see
                # _rehome_prefix), not here — these blocks free the moment
                # the transfer below completes
            # drain sending queue (transfer is synchronous at this scale)
            for req in list(engine.scheduler.prefill.sending):
                self._transfer(req)
            for req in finished:
                req.finish_time = self.clock
                req.finish_wall = time.monotonic()
                if self.tracer is not None:
                    self.tracer.emit(
                        req.request_id, "decode",
                        start_cycle=req.transfer_end, end_cycle=self.clock,
                        start_wall_s=req.transfer_end_wall,
                        end_wall_s=req.finish_wall, node_id=nid,
                        attrs={"new_tokens": req.num_output,
                               "decode_steps": req.decode_steps,
                               "decode_dispatches": req.decode_dispatches})
                self.finished.append(req)
        self.controller.step(self.clock)
        self._collect_rejected()   # deferred requests the gate gave up on

    def run(self, requests: List[Request], max_cycles: int = 1000) -> List[Request]:
        """Batch compatibility wrapper over submit()/step().

        New code should use :class:`repro_torch.serving.api.FlowKVClient`, which
        exposes the same loop through streaming per-request handles.
        """
        for r in requests:
            self.submit(r)
        for _ in range(max_cycles):
            self.step()
            if self.submitted and \
                    len(self.finished) + len(self.cancelled) + \
                    len(self.rejected) >= self.submitted:
                break
        return self.finished

    # -- request lifecycle --------------------------------------------------------------
    def cancel(self, req: Request) -> bool:
        """Abort a request wherever it is; frees its blocks/state on EVERY
        node (prefill, decode, or mid-transfer). Returns False if the
        request already finished."""
        if req.state in (RequestState.FINISHED, RequestState.CANCELLED,
                         RequestState.REJECTED):
            return False
        for engine in self.engines.values():
            engine.release(req)
        # a FAILED request may be parked controller-side awaiting reroute —
        # cancellation must beat the reroute, not race it
        for q in (self.controller.retry_queue, self.controller.deferred):
            try:
                q.remove(req)
            except ValueError:
                pass
        req.state = RequestState.CANCELLED
        req.finish_time = self.clock
        req.finish_wall = time.monotonic()
        self.cancelled.append(req)
        return True

    def set_role(self, node_id: int, role: str) -> bool:
        """Reassign a node P<->D mid-run (delegates to the controller)."""
        return self.controller.set_role(node_id, role)

    # -- fault tolerance ----------------------------------------------------------------
    def kill_node(self, node_id: int) -> None:
        """Simulate node death: it stops heartbeating and doing work; the
        controller's next heartbeat scan drains and re-routes its requests.

        Every paged-KV allocation on the dead node is released immediately —
        the controller's drain only frees requests still sitting in the
        scheduler queues, so without this the dead pool reports phantom
        utilization after checkpoint/restore or pool reuse.

        Note the node simply STOPS heartbeating — detection is pure
        staleness against ``heartbeat_timeout_cycles``, no sentinel stamp —
        so the detection latency the controller pays is the real knob."""
        self._dead.add(node_id)
        self.fault_kills += 1
        engine = self.engines[node_id]
        tm = self.tiers.get(node_id)
        if tm is not None:
            # the host tier dies with the node: detach the demotion hook
            # FIRST so release_all's cache drop cannot copy into a pool that
            # no longer exists, then drop its residency advertisements
            engine.scheduler.bm.on_evict = None
            tm.clear()
        engine.scheduler.bm.release_all()
        engine.spilled.clear()
        engine.spilled_state.clear()
        engine.states.clear()
        if engine.slots is not None:
            engine.slots.release_all()

    def checkpoint(self) -> dict:
        from repro_torch.serving.checkpoint import cluster_state
        return cluster_state(self)

    # -- leak auditing ------------------------------------------------------------------
    def live_request_ids(self) -> set:
        """Cluster-wide live set: every request still in ANY node's queues
        or parked controller-side. The union matters: a SENDING request's
        dst-side registration lives on the destination bm while the request
        itself sits in the SOURCE's sending queue."""
        live = set()
        for engine in self.engines.values():
            s = engine.scheduler
            for sub in (s.prefill, s.decode):
                for q in (sub.waiting, sub.running, sub.swapped, sub.sending):
                    live.update(r.request_id for r in q)
        live.update(r.request_id for r in self.controller.retry_queue)
        live.update(r.request_id for r in self.controller.deferred)
        return live

    def audit_blocks(self) -> int:
        """Count leaked block tables fleet-wide (0 on a healthy cluster),
        checking each allocator's structural invariants on the way."""
        live = self.live_request_ids()
        leaked = 0
        for engine in self.engines.values():
            bm = engine.scheduler.bm
            bm.check_invariants()
            leaked += sum(1 for rid in bm._table if rid not in live)
        for tm in self.tiers.values():
            if tm.node_id not in self._dead:
                tm.check_invariants()
        return leaked

    def assert_no_leaks(self) -> None:
        """Hard audit (tests / chaos gate): raise on any leaked table."""
        live = self.live_request_ids()
        for engine in self.engines.values():
            engine.scheduler.bm.assert_no_leaks(live)

    def stats(self) -> Dict[str, float]:
        kv_xfers = [t for t in self.transfers
                    if t.kind == "kv" and t.status == "ok"]
        lat = [t.est_latency_s for t in kv_xfers]
        calls = [t.num_calls for t in kv_xfers]
        disp = [t.num_dispatches for t in kv_xfers]
        hidden = sum(t.hidden_s for t in kv_xfers)
        wire = hidden + sum(lat)
        ttfts = [t for t in (r.ttft() for r in self.finished) if t is not None]
        d_steps = sum(e.decode_steps for e in self.engines.values())
        d_disp = sum(e.decode_dispatches for e in self.engines.values())
        return {
            # prefix-reuse data plane: compute the cluster actually ran vs
            # skipped, and how the hits were sourced
            "prefill_tokens_computed": sum(
                e.prefill_tokens_computed for e in self.engines.values()),
            "prefix_hits": sum(e.prefix_hits for e in self.engines.values()),
            "prefix_tokens_reused": sum(
                e.prefix_tokens_reused for e in self.engines.values()),
            "prefix_fetches": sum(
                1 for t in self.transfers if t.kind == "prefix_fetch"),
            "finished": len(self.finished),
            "cancelled": len(self.cancelled),
            "rejected": len(self.rejected),
            "deferred": len(self.controller.deferred),
            "transfers": len(kv_xfers),
            "mean_transfer_s": sum(lat) / len(lat) if lat else 0.0,
            "mean_transfer_calls": sum(calls) / len(calls) if calls else 0.0,
            "mean_transfer_dispatches": sum(disp) / len(disp) if disp else 0.0,
            # layer-window overlap: wire time hidden behind prefill compute
            # (est_latency_s above is the EXPOSED remainder)
            "transfer_hidden_s": hidden,
            "transfer_hidden_frac": hidden / wire if wire else 0.0,
            "mean_ttft_cycles": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            # decode data plane: dispatches per cycle is the zero-gather
            # invariant (1.0 on the paged-kernel path, O(batch) on the oracle)
            "decode_steps": d_steps,
            "decode_dispatches": d_disp,
            "mean_decode_dispatches_per_step": d_disp / d_steps if d_steps else 0.0,
            # union, not sum: same-config engines share one jitted step, so a
            # bucket two nodes both hit compiled once
            "decode_compile_variants": len(set().union(
                *(e._decode_cache_keys for e in self.engines.values()))),
            "events": len(self.controller.events),
            # mesh-parallel plane: nodes running sharded (tp>1), the largest
            # degree in the fleet, and per-shard-pair transfer launches
            # landed in sharded pools
            "sharded_nodes": sum(
                1 for e in self.engines.values() if e.tp_degree > 1),
            "max_tp_degree": max(
                (e.tp_degree for e in self.engines.values()), default=1),
            "shard_dispatches": sum(
                getattr(e.kv, "shard_dispatches", 0) for e in self.engines.values()),
            # fault plane: injected kills, failed transfer attempts retried,
            # transfers that gave up and recomputed, completed failovers —
            # and the leak audit (must stay 0.0, chaos or not)
            "fault_kills": self.fault_kills,
            "transfer_retries": self.transfer_retry_count,
            "degraded_to_recompute": self.degraded_to_recompute,
            "recoveries": self.recoveries,
            "leaked_blocks": float(self.audit_blocks()),
            # tier plane: pool blocks demoted to / promoted from host DRAM,
            # and the LRU cache's own reuse/eviction traffic
            "tier_demoted_blocks": sum(
                t.demoted_blocks for t in self.tiers.values()),
            "tier_promoted_blocks": sum(
                t.promoted_blocks for t in self.tiers.values()),
            "tier_host_resident": sum(
                t.host.num_resident for t in self.tiers.values()),
            "cached_reused": sum(
                e.scheduler.bm.cached_reused for e in self.engines.values()),
            "cached_evicted": sum(
                e.scheduler.bm.cached_evicted for e in self.engines.values()),
        }
