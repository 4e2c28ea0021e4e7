"""Discrete-event PD-cluster simulator.

The control plane is REAL: each simulated node owns an actual
``HybridScheduler`` + ``BlockManager`` (segment or freelist allocator), and
the global controller is the actual ``GlobalController``. Only the data
plane is virtual — step durations come from the hardware cost models and
transfer latencies from the exact ``TransferPlanner`` call counts over the
Table-3-calibrated transport profiles. This is what lets the simulator
reproduce the paper's throughput tables while exercising the same scheduler
code the CPU-scale runtime runs.

``SystemKind`` encodes the paper's comparison set:

  flowkv        — segment allocator, aligned transfer, load-aware scheduling
  vllm_disagg   — freelist allocator, per-layer buffer-merge transfer,
                  fixed roles, least-loaded routing
  mooncake      — freelist, RDMA-profile transfer (no NIC-direct VRAM)
  distserve     — fixed roles, NO chunked prefill (one prefill at a time)
  vllm_colocated— single-instance P+D with chunked prefill interference
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.scheduler.global_controller import (AdmissionPolicy,
                                                    GlobalController, ModelCost,
                                                    NodeHandle)
from repro_torch.core.scheduler.hybrid_scheduler import HybridScheduler
from repro_torch.core.block_manager import BlockManager, OutOfBlocksError
from repro_torch.core.costmodel import (HOST_DRAM, MOONCAKE_RDMA, NCCL_ENI, IPC,
                                  VLLM_MERGE_ENI, VLLM_MERGE_INTRA,
                                  TransportProfile, layer_window_overlap,
                                  select_route)
from repro_torch.core.layout import KVCacheSpec
from repro_torch.core.transfer import TransferPlanner, get_backend
from repro_torch.faults import as_injector
from repro_torch.models.common import ModelConfig
from repro_torch.serving.host_tier import TierManager
from repro_torch.serving.request import Request, RequestState
from repro_torch.sim.events import EventQueue
from repro_torch.sim.hardware import A100, HardwareProfile

SYSTEMS = ("flowkv", "vllm_disagg", "mooncake", "distserve", "vllm_colocated")

# Routing policies for the scenario suite (benchmarks/scenarios.py):
#   load_aware  — the full FlowKV control plane: smoothed-score routing,
#                 regime actions (role switch / flip / scale) and, when an
#                 AdmissionPolicy is set, the overload admission gate.
#   round_robin — blind rotation over P and D nodes; controller PASSIVE
#                 (observes and classifies but never acts).
#   static_pd   — fixed role partition, round-robin P, least-instantaneous-
#                 queue D (the classic disaggregated baseline); controller
#                 PASSIVE.
# Constructing with routing=None keeps the legacy behavior: the system
# spec's load_aware bit picks between the controller path and static_pd
# routing with the controller left ACTIVE (exactly the pre-scenario code).
ROUTING_POLICIES = ("load_aware", "round_robin", "static_pd")


@dataclasses.dataclass
class SystemSpec:
    kind: str
    allocator: str
    schedule: str                      # transfer schedule
    chunked_prefill: bool
    load_aware: bool
    colocated: bool = False
    transfer_intra: Optional[TransportProfile] = None
    transfer_inter: Optional[TransportProfile] = None
    # fraction of transfer latency that BLOCKS the sender's compute stream
    # (paper §1/§3.3: per-block NCCL kernels contend with GEMMs; FlowKV's
    # single merged call all but removes this)
    transfer_blocking: float = 0.5


def system_spec(kind: str) -> SystemSpec:
    if kind == "flowkv":
        return SystemSpec(kind, "flowkv", "flowkv", True, True,
                          transfer_intra=IPC, transfer_inter=NCCL_ENI,
                          transfer_blocking=0.05)
    if kind == "vllm_disagg":
        return SystemSpec(kind, "freelist", "blockwise", True, False,
                          transfer_intra=VLLM_MERGE_INTRA,
                          transfer_inter=VLLM_MERGE_ENI)
    if kind == "mooncake":
        return SystemSpec(kind, "freelist", "blockwise", True, False,
                          transfer_intra=MOONCAKE_RDMA,
                          transfer_inter=MOONCAKE_RDMA,
                          transfer_blocking=0.3)
    if kind == "distserve":
        # modeled without continuous prefill batching (one prompt at a time) —
        # reproduces the paper's observed long-prompt saturation (Table 1/2)
        return SystemSpec(kind, "freelist", "blockwise", False, False,
                          transfer_intra=VLLM_MERGE_INTRA,
                          transfer_inter=VLLM_MERGE_ENI)
    if kind == "vllm_colocated":
        return SystemSpec(kind, "freelist", "blockwise", True, False,
                          colocated=True,
                          transfer_intra=IPC, transfer_inter=NCCL_ENI)
    raise ValueError(f"unknown system {kind!r}")


class SimNode:
    def __init__(self, node_id: int, role: str, hw: HardwareProfile,
                 spec: SystemSpec, kv_spec: KVCacheSpec, cost: ModelCost,
                 max_batch_tokens: int, chunked_prefill: Optional[bool] = None,
                 prefill_chunk_tokens: Optional[int] = None, tp: int = 1):
        self.node_id = node_id
        self.role = role
        self.hw = hw
        self.spec = spec
        self.kv_spec = kv_spec
        self.cost = cost
        # mesh-parallel degree of this node: tp chips execute the model
        # cooperatively, so per-token FLOPs and weight/KV bytes are split
        # tp-ways across the aggregate fleet FLOPs/bandwidth (the same
        # aggregate the controller's capability stamping uses). The SAME
        # attribute name the sharded transfer backend reads (duck-typed
        # against ShardedKVCache.tp), so cross-degree P->D plans price one
        # fused dispatch per overlapping shard pair.
        self.tp = tp
        # chunked_prefill override (None = the system spec's baseline bit);
        # SAME HybridScheduler knobs as the real NodeEngine, so chunk-size
        # semantics cannot drift between sim and engine (parity-tested).
        chunked = spec.chunked_prefill if chunked_prefill is None \
            else chunked_prefill
        self.chunked_prefill = chunked
        self.bm = BlockManager(kv_spec.num_blocks, kv_spec.block_size, spec.allocator)
        self.scheduler = HybridScheduler(
            node_id, self.bm,
            max_batch_tokens=max_batch_tokens if chunked else 1 << 30,
            chunked_prefill=chunked,
            prefill_chunk_tokens=prefill_chunk_tokens,
            # distserve-style: whole-prompt prefill, one prompt at a time
            # (no sarathi chunking) — reproduces the long-prompt saturation
            max_running=1 if (role == "prefill" and not chunked) else 64,
        )
        if spec.colocated:
            self.scheduler.set_priority("both")
        self.busy_until = 0.0
        self.planner = TransferPlanner(kv_spec)
        # scenario bookkeeping: work this node actually executed (a node with
        # both at 0 at the end of a run was STARVED by the routing policy)
        self.served_prefill = 0     # requests that ran a prefill chunk here
        self.served_decode = 0      # request-cycles decoded here
        self.prefill_tokens_computed = 0   # prompt tokens actually priced

    # -- cost model ----------------------------------------------------------
    def prefill_duration(self, num_tokens: int) -> float:
        return self.hw.prefill_time(
            num_tokens * self.cost.flops_per_token / self.tp)

    def decode_duration(self, batch: List[Request]) -> float:
        kv_bytes = sum(self.cost.kv_bytes_per_token * r.total_len for r in batch)
        return self.hw.decode_time(
            (self.cost.weight_bytes + kv_bytes) / self.tp)


class ClusterSim:
    def __init__(self, cfg: ModelConfig, kind: str, *, num_prefill: int = 1,
                 num_decode: int = 1, hw_prefill: HardwareProfile = A100,
                 hw_decode: Optional[HardwareProfile] = None,
                 hw_nodes: Optional[Sequence[HardwareProfile]] = None,
                 same_host: bool = True, blocks_per_node: int = 8192,
                 max_batch_tokens: int = 8192, tp: int = 1,
                 tp_degrees: Optional[Dict[int, int]] = None,
                 routing: Optional[str] = None,
                 role_flip: bool = False,
                 admission: Optional[AdmissionPolicy] = None,
                 prefix_reuse: Optional[bool] = None,
                 host_tier_blocks: int = 0,
                 chunked_prefill: Optional[bool] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 layer_window: int = 0,
                 faults=None,
                 heartbeat_timeout: float = 10.0):
        self.cfg = cfg
        self.spec = system_spec(kind)
        self.kind = kind
        self.same_host = same_host
        # Fault plane (mirrors PDCluster): a repro_torch.faults.FaultInjector (or
        # spec list / capture-meta dict) schedules node crashes on the event
        # clock, verdicts transfer attempts, degrades bandwidth and
        # suppresses heartbeats. The sim's transfer faults are PRICED-only
        # (virtual data plane): a failed/corrupt attempt adds the retry
        # backoff to the wire latency — the same control-flow path the real
        # cluster takes, minus the actual bytes.
        self.faults = as_injector(faults)
        self.heartbeat_timeout = heartbeat_timeout
        self.transfer_max_retries = 3
        self.transfer_backoff_s = 0.05
        self._dead: set = set()      # killed nodes stop heartbeating/working
        self.fault_kills = 0
        self.transfer_retry_count = 0
        self.degraded_to_recompute = 0
        self.recoveries = 0
        # chunked_prefill / prefill_chunk_tokens override the system spec's
        # baseline bit per run (A/B: lockstep vs sarathi-chunked on the SAME
        # system); layer_window > 0 prices layerwise transfer/compute
        # overlap exactly like PDCluster._transfer_windowed does.
        self.chunked_override = chunked_prefill
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.layer_window = layer_window
        # Optional repro_torch.obs.tracing.SpanRecorder (attach_tracer). The sim
        # emits the same span taxonomy as PDCluster on the SIMULATED clock
        # (start_cycle/end_cycle in sim seconds); wall stamps stay None —
        # the virtual data plane consumes no wall time worth attributing.
        self.tracer = None
        hw_decode = hw_decode or hw_prefill
        if routing is not None and routing not in ROUTING_POLICIES:
            raise ValueError(
                f"routing must be one of {ROUTING_POLICIES}, got {routing!r}")
        # legacy construction (routing=None): spec.load_aware picks the path
        # and the controller stays active, exactly as before the scenario
        # suite existed; explicit baselines get a passive controller.
        self.routing = routing or \
            ("load_aware" if self.spec.load_aware else "static_pd")
        passive = routing is not None and routing != "load_aware"
        n_attn = cfg.num_attention_layers() or cfg.num_layers
        self.kv_spec = KVCacheSpec(
            num_layers=n_attn, num_blocks=blocks_per_node,
            block_size=cfg.block_size, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, dtype=cfg.dtype)
        cost = ModelCost(
            flops_per_token=2.0 * cfg.active_params() / tp,
            kv_bytes_per_token=float(cfg.kv_bytes_per_token() or 1024) / tp,
            weight_bytes=2.0 * cfg.num_params() / tp,
        )
        self.cost = cost
        self.controller = GlobalController(cost, cfg.block_size,
                                           target="gpu",
                                           role_flip=role_flip,
                                           admission=admission,
                                           actions_enabled=not passive,
                                           layer_window=layer_window,
                                           num_layers=n_attn,
                                           heartbeat_timeout=heartbeat_timeout)
        # deferred admissions re-routed inside controller.step need their
        # target node's event loop poked (event-driven runtime)
        self.controller.on_admit = lambda req: self._poke(req.prefill_node)
        self.nodes: Dict[int, SimNode] = {}
        if self.spec.colocated:
            # same GPU budget as 1P1D: two colocated hybrid instances
            roles = [("prefill", hw_prefill)] * (num_prefill + num_decode)
        else:
            roles = [("prefill", hw_prefill)] * num_prefill + \
                    [("decode", hw_decode)] * num_decode
        if hw_nodes is not None:
            # heterogeneous fleet: per-node profile overrides (same length)
            if len(hw_nodes) != len(roles):
                raise ValueError(
                    f"hw_nodes has {len(hw_nodes)} profiles for {len(roles)} nodes")
            roles = [(role, hw_nodes[i]) for i, (role, _) in enumerate(roles)]
        # Prefix-reuse mirror of the real runtime (priced, virtual data
        # plane). Default: only the FlowKV system under load-aware routing
        # has a global prefix cache — baselines never claim hits.
        if prefix_reuse is None:
            prefix_reuse = self.spec.load_aware and self.routing == "load_aware"
        self.prefix_reuse = prefix_reuse
        # Host-DRAM tier mirror: the SAME TierManager class the real cluster
        # wires (kv=None = bookkeeping-only pools), so demote/promote
        # decisions and span sequences are identical by construction. The
        # priced legs are the promote latencies (HOST_DRAM profile) charged
        # where the real cluster pays the host->HBM copy.
        self.host_tier_blocks = host_tier_blocks
        self.tiers: Dict[int, TierManager] = {}
        # per-node mesh-parallel degrees (node_id -> tp). The legacy global
        # ``tp`` knob keeps dividing ModelCost uniformly; ``tp_degrees``
        # instead scales individual nodes (a TP=4 prefill node runs 4x the
        # aggregate FLOPs of a TP=1 decode node) and stamps the degree onto
        # the controller handle, so capability normalization, TTFT estimates
        # and the shard-pair transfer pricing all see the topology.
        self.tp_degrees: Dict[int, int] = dict(tp_degrees or {})
        for i, (role, hw) in enumerate(roles):
            node_tp = self.tp_degrees.get(i, 1)
            node = SimNode(i, role, hw, self.spec, self.kv_spec, cost,
                           max_batch_tokens, chunked_prefill=chunked_prefill,
                           prefill_chunk_tokens=prefill_chunk_tokens,
                           tp=node_tp)
            self.nodes[i] = node
            self.controller.register_node(NodeHandle(
                node_id=i, role=role, host_id=0 if same_host else i,
                hardware=hw, scheduler=node.scheduler,
                supports_prefix_reuse=prefix_reuse,
                tp_degree=node_tp))
            # same residency honesty as the real cluster: physical frees
            # drop the freed blocks' index entries
            node.bm.on_free = \
                (lambda blocks, nid=i:
                 self.controller.prefix_index.invalidate_blocks(nid, blocks))
            if prefix_reuse:
                node.scheduler.resolve_prefix = self._make_resolver(node)
                # host tier mirrors the real cluster's tp==1 restriction:
                # whole-payload page moves don't span sharded pools
                if host_tier_blocks > 0 and node_tp == 1:
                    self.tiers[i] = TierManager(
                        i, node.bm, self.controller.prefix_index,
                        self.kv_spec, host_tier_blocks, kv=None,
                        schedule=self.spec.schedule,
                        get_tracer=lambda: self.tracer,
                        get_clock=lambda: self.eq.now).attach()
        if self.spec.colocated:
            for node in self.nodes.values():
                node.scheduler.set_priority("both")
        self.eq = EventQueue()
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self.offered = 0
        self._rr = 0   # round-robin cursor
        self.transfer_latencies: List[float] = []   # EXPOSED latencies
        self.transfer_calls: List[int] = []
        self.transfer_dispatches: List[int] = []
        self.transfer_hidden: List[float] = []      # wire time hidden by overlap
        self.prefix_hits = 0               # prefills that reused a prefix
        self.prefix_tokens_reused = 0      # prompt tokens never priced
        self.prefix_fetches = 0            # remote fetches executed
        self.prefix_fetch_dispatches: List[int] = []
        self._poll_scheduled: Dict[int, bool] = {i: False for i in self.nodes}
        self._recheck_scheduled = False   # admission-recheck event in flight

    def _make_resolver(self, node: SimNode):
        """Admission-time prefix resolution: same shared controller helper
        as PDCluster, so engine and sim semantics cannot drift."""
        nid, bm = node.node_id, node.bm
        return lambda req: self.controller.resolve_local_prefix(
            nid, req, bm.block_alive)

    # -- routing ------------------------------------------------------------------
    def _route(self, req: Request) -> None:
        self.offered += 1
        if self.routing == "load_aware":
            decision = self.controller.submit_request(req)
            self._collect_rejected()
            if not decision.admitted:
                if decision.verdict == "deferred":
                    # deferred re-evaluation runs in controller.step, which
                    # only fires from _complete — keep a recheck event alive
                    # so a deferral on an otherwise-idle cluster cannot
                    # strand the request with an empty event queue
                    self._schedule_admission_recheck()
                return
        elif self.routing == "round_robin":
            # blind rotation over both sides, no load signal at all
            pn = self.controller.prefill_nodes() or \
                [n for n in self.controller.nodes.values() if n.alive]
            dn = self.controller.decode_nodes() or pn
            p = pn[self._rr % len(pn)]
            d = dn[self._rr % len(dn)]
            self._rr += 1
            req.decode_node = d.node_id
            p.scheduler.enqueue_prefill(req)
        else:
            # static_pd: fixed roles, round-robin P, least-loaded D node
            pn = [n for n in self.controller.prefill_nodes()]
            p = pn[req.request_id % len(pn)]
            dn = self.controller.decode_nodes() or pn
            d = min(dn, key=lambda n: len(n.scheduler.decode.running))
            req.decode_node = d.node_id
            p.scheduler.enqueue_prefill(req)
        node_id = req.prefill_node
        self._poke(node_id)

    def _collect_rejected(self) -> None:
        for r in self.controller.take_rejected():
            r.finish_time = self.eq.now
            self.rejected.append(r)

    def _schedule_admission_recheck(self, period: float = 0.05) -> None:
        """Periodic controller tick while any request sits deferred."""
        if self._recheck_scheduled:
            return
        self._recheck_scheduled = True

        def recheck():
            self._recheck_scheduled = False
            self._heartbeat_all(self.eq.now)
            self.controller.step(self.eq.now)
            self._collect_rejected()
            if self.controller.deferred:
                self._schedule_admission_recheck(period)

        self.eq.push(self.eq.now + period, recheck)

    def _poke(self, node_id: int) -> None:
        """Schedule a scheduling-cycle poll for a node if idle."""
        if self._poll_scheduled.get(node_id):
            return
        self._poll_scheduled[node_id] = True
        node = self.nodes[node_id]
        self.eq.push(max(self.eq.now, node.busy_until), lambda: self._cycle(node_id))

    # -- fault plane --------------------------------------------------------------------
    def _heartbeat_all(self, now: float) -> None:
        """Refresh every HEALTHY node's heartbeat (idle != dead in the sim —
        failure is explicit), skipping killed and suppressed nodes so
        staleness detection can actually fire on them."""
        for nid, handle in self.controller.nodes.items():
            if handle.alive and nid not in self._dead and \
                    (self.faults is None or
                     not self.faults.heartbeat_suppressed(nid, now)):
                self.controller.heartbeat(nid, now)

    def kill_node(self, node_id: int) -> None:
        """Node death on the event clock: it stops heartbeating and working
        (no sentinel stamp — detection is pure staleness), its pool is
        released, and a failure-check event is scheduled past the heartbeat
        timeout so detection fires even on an otherwise-idle cluster."""
        self._dead.add(node_id)
        self.fault_kills += 1
        # the host tier dies with the node: detach the demotion hook BEFORE
        # the pool teardown (nowhere to demote to), then drop its entries
        self.nodes[node_id].bm.on_evict = None
        tm = self.tiers.get(node_id)
        if tm is not None:
            tm.clear()
        self.nodes[node_id].bm.release_all()
        self.eq.push(self.eq.now + self.heartbeat_timeout + 1e-6,
                     self._failure_check)

    def _failure_check(self) -> None:
        """Heartbeat the healthy fleet, then let the controller's staleness
        scan drain + reroute whatever went quiet."""
        self._heartbeat_all(self.eq.now)
        self.controller.step(self.eq.now)
        self._collect_rejected()

    def _finish_recovery(self, req: Request, node_id: int, now: float) -> None:
        """Close the failure→re-prefilled window (same semantics as
        PDCluster._finish_recovery, sim clock only)."""
        req.recovery_s += now - req.recovery_start
        req.recoveries += 1
        self.recoveries += 1
        if self.tracer is not None:
            self.tracer.emit(
                req.request_id, "recovery",
                start_cycle=req.recovery_start, end_cycle=now,
                node_id=node_id,
                attrs={"replayed_tokens": req.replayed_tokens,
                       "retries": req.retries})
        req.recovery_start = None
        req.recovery_start_wall = None

    # -- tier promotion (mirrors PDCluster._promote_pending, priced) -----------------
    def _promote_pending(self, node: SimNode) -> float:
        """Lift the head-of-line waiting request's LOCAL host-tier prefix
        back into the pool before this node schedules; returns the priced
        host->HBM latency (charged against this node's compute stream —
        where the real cluster pays the actual copy)."""
        tm = self.tiers.get(node.node_id)
        if tm is None or not node.scheduler.prefill.waiting:
            return 0.0
        req = node.scheduler.prefill.waiting[0]
        if node.bm.owns(req.request_id):
            return 0.0
        if req.prefix_src_node is not None and \
                req.prefix_src_node != node.node_id:
            return 0.0   # remote plan: promotion happens at the SOURCE node
        if tm.promote_match(req.prompt_tokens, trace_id=req.request_id,
                            profile=HOST_DRAM):
            return tm.last_promote_latency_s
        return 0.0

    # -- prefix fetch (mirrors PDCluster._fetch_prefix, priced) ----------------------
    def _fetch_pending_prefixes(self, node: SimNode) -> None:
        """Start the remote-prefix pull for this node's next admission.

        Head-of-line only, like the real cluster: queue-tail fetches could
        starve a large head request of free blocks. The request leaves the
        waiting queue for the fetch's (priced) latency — exactly ONE
        fused-dispatch plan per fetch, same descriptor tables as hardware —
        and re-enters it when the blocks land, so admission can only share
        a prefix that is actually resident."""
        if not node.scheduler.prefill.waiting:
            return
        req = node.scheduler.prefill.waiting[0]
        src_id = req.prefix_src_node
        if src_id is None or src_id == node.node_id or \
                node.bm.owns(req.request_id):
            return
        src = self.nodes.get(src_id)
        if src is None:
            req.clear_prefix_plan()
            return
        # Source-side promotion first (same ordering as the real cluster):
        # demote->promote changes physical ids, so the routed block list is
        # refreshed before validation. The host->HBM leg is a priced serial
        # prelude to the wire fetch.
        promote_s = 0.0
        src_tm = self.tiers.get(src_id)
        if src_tm is not None and \
                src_tm.promote_match(req.prompt_tokens,
                                     trace_id=req.request_id,
                                     profile=HOST_DRAM):
            promote_s = src_tm.last_promote_latency_s
            if not self.controller.refresh_prefix_plan(req):
                return   # nothing shareable survived promotion
        if not self.controller.validate_prefix_plan(req):
            return   # stale plan cleared by the shared validator
        hit = req.num_cached_prefix_tokens
        if not node.bm.can_allocate(hit):
            return   # destination pool full — retry next cycle
        dst_blocks = node.bm.allocate(req.request_id, hit)
        plan = src.planner.plan(self.spec.schedule,
                                req.prefix_block_ids, dst_blocks)
        profile = (self.spec.transfer_intra if self.same_host
                   else self.spec.transfer_inter)
        latency = plan.latency(profile) + promote_s
        self.prefix_fetches += 1
        self.prefix_fetch_dispatches.append(plan.num_dispatches)
        req.prefix_fetch_dispatches = plan.num_dispatches
        node.scheduler.prefill.waiting.remove(req)

        start = self.eq.now

        def arrive(req=req, dst_blocks=dst_blocks, hit=hit,
                   nid=node.node_id):
            if self.tracer is not None:
                self.tracer.emit(
                    req.request_id, "prefix_fetch",
                    start_cycle=start, end_cycle=self.eq.now, node_id=nid,
                    attrs={"src_node": src_id, "tokens": hit,
                           "dispatches": plan.num_dispatches,
                           "bytes": plan.total_bytes,
                           "est_latency_s": latency})
            dst = self.nodes[nid]
            if nid in self._dead or not self.controller.nodes[nid].alive:
                dst.bm.free(req.request_id)   # node died mid-fetch
                self.controller._stamp_failure(req, self.eq.now, nid,
                                               "node_died_mid_fetch")
                req.reset_for_retry()
                self.controller.retry_queue.append(req)
                return
            self.controller.record_prefix(nid, req.prompt_tokens[:hit],
                                          dst_blocks)
            req.prefix_src_node = nid
            req.prefix_block_ids = dst_blocks
            # the prefix is resident: back to the HEAD (this request's
            # admission was what the fetch was for)
            dst.scheduler.prefill.waiting.appendleft(req)
            self._poke(nid)

        self.eq.push(self.eq.now + latency, arrive)

    def _rehome_prefix(self, req: Request, node_id: int,
                       blocks: Sequence[int]) -> None:
        """Advertise a prompt's full-block prefix where its KV now lives
        (shared controller helper — sim and engine can never drift)."""
        if self.prefix_reuse:
            self.controller.rehome_prefix(req, node_id, blocks)

    # -- node cycle -----------------------------------------------------------------
    def _cycle(self, node_id: int) -> None:
        self._poll_scheduled[node_id] = False
        node = self.nodes[node_id]
        handle = self.controller.nodes[node_id]
        if not handle.alive or node_id in self._dead:
            return
        if self.faults is None or \
                not self.faults.heartbeat_suppressed(node_id, self.eq.now):
            self.controller.heartbeat(node_id, self.eq.now)
        promote_s = 0.0
        if self.prefix_reuse:
            promote_s = self._promote_pending(node)
            self._fetch_pending_prefixes(node)
        decision = node.scheduler.schedule()
        # a local promote is a serial host->HBM copy ahead of this cycle's
        # compute (the real engine blocks on the actual dispatch)
        duration = promote_s
        if decision.prefill_batch:
            tokens = decision.num_prefill_tokens
            duration += node.prefill_duration(tokens)
            for req in decision.prefill_batch:
                # first scheduled chunk = compute starts (the real engine
                # stamps this in run_prefill); queue_s / prefill_s and the
                # queue span depend on it
                if req.prefill_start is None:
                    req.prefill_start = self.eq.now
            node.scheduler.last_compute_util = 1.0
            node.served_prefill += len(decision.prefill_batch)
            # chunks are suffix-sized on a hit: the simulator prices exactly
            # the compute the real engine would run
            node.prefill_tokens_computed += tokens
        if decision.decode_batch:
            duration += node.decode_duration(decision.decode_batch)
            node.served_decode += len(decision.decode_batch)
            # same signal as NodeEngine.run_decode: the admitted batch's
            # progress fraction — identically 1.0 here because every
            # simulated decode request progresses each cycle.
            node.scheduler.last_bandwidth_util = 1.0
        if not decision.prefill_batch and not decision.decode_batch:
            node.scheduler.last_compute_util = 0.0
            node.scheduler.last_bandwidth_util = 0.0
            if promote_s:
                node.busy_until = max(node.busy_until,
                                      self.eq.now + promote_s)
            return   # idle: next arrival/transfer will poke us
        node.busy_until = self.eq.now + duration
        self.eq.push(node.busy_until,
                     lambda: self._complete(node_id, decision))

    def _complete(self, node_id: int, decision) -> None:
        if node_id in self._dead or not self.controller.nodes[node_id].alive:
            return   # killed mid-batch: the in-flight work is lost (the
            #          failure drain requeues its requests token-exactly)
        node = self.nodes[node_id]
        now = self.eq.now
        # prefill completions
        for req in list(decision.prefill_batch):
            chunk = decision.prefill_chunks.get(req.request_id, req.prompt_len)
            offset = node.scheduler.prefill_tokens_done(req)
            executed = min(chunk, req.prompt_len - offset)
            if self.tracer is not None and executed > 0:
                # same zero-width per-chunk span the real engine emits, so
                # sim and engine chunk sequences are directly comparable
                # (tests/test_chunked_prefill.py parity test)
                self.tracer.emit(
                    req.request_id, "prefill_chunk",
                    start_cycle=now, end_cycle=now, node_id=node_id,
                    attrs={"offset": offset, "tokens": executed,
                           "prompt_len": req.prompt_len,
                           "final": offset + executed == req.prompt_len})
            if node.scheduler.prefill_progressed(req, chunk):
                req.prefill_end = now
                # recovery re-prefill already HAS its tokens (kept across
                # reset_for_retry) — same final-append guard as the engine
                if not req.output_tokens:
                    req.output_tokens.append(0)   # first token (virtual)
                # the first token is EMITTED here, by prefill — TTFT must not
                # include the transfer (same fix as the real cluster)
                if req.first_token_time is None:
                    req.first_token_time = now
                if req.recovery_start is not None:
                    self._finish_recovery(req, node_id, now)
                if self.tracer is not None:
                    self.tracer.emit(
                        req.request_id, "queue",
                        start_cycle=req.arrival_time,
                        end_cycle=req.prefill_start, node_id=node_id,
                        attrs={"defers": req.admission_defers,
                               "retries": req.retries})
                    self.tracer.emit(
                        req.request_id, "prefill",
                        start_cycle=req.prefill_start, end_cycle=now,
                        node_id=node_id,
                        attrs={"prompt_len": req.prompt_len,
                               "cached_prefix_tokens":
                                   req.num_cached_prefix_tokens})
                if req.num_cached_prefix_tokens:
                    self.prefix_hits += 1
                    self.prefix_tokens_reused += req.num_cached_prefix_tokens
                if self.spec.colocated:
                    node.scheduler.bm  # same pool: no transfer
                    node.scheduler.enqueue_decode(req)
                    self._rehome_prefix(req, node_id,
                                        node.bm.get(req.request_id))
                else:
                    node.scheduler.mark_sending(req)
                    # the final chunk's compute is the window layer-wise
                    # transfer overlap hides behind (same stamp the real
                    # engine records in run_prefill)
                    req.last_prefill_chunk_tokens = chunk
                    self._start_transfer(req, now)
        # decode completions (one token per request per cycle)
        for req in list(decision.decode_batch):
            req.output_tokens.append(0)
            if req.first_token_time is None:
                req.first_token_time = now
            if req.num_output >= req.sampling.max_new_tokens:
                node.scheduler.decode_finished(req)
                req.finish_time = now
                if self.tracer is not None:
                    self.tracer.emit(
                        req.request_id, "decode",
                        start_cycle=req.transfer_end, end_cycle=now,
                        node_id=node_id,
                        attrs={"new_tokens": req.num_output})
                self.finished.append(req)
        # keep heartbeats fresh for all healthy nodes (failure injection is
        # explicit in this simulator; idle != dead)
        self._heartbeat_all(now)
        self.controller.step(now)
        self._collect_rejected()   # deferred admissions the gate gave up on
        self._poke(node_id)

    # -- transfer ----------------------------------------------------------------------
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

    def _degrade_to_recompute(self, req: Request, src: SimNode, dst: SimNode,
                              now: float) -> None:
        """Retry-exhausted transfer (mirror of the real cluster): drop both
        sides' blocks and re-prefill token-exactly on the decode node."""
        if dst.bm.owns(req.request_id):
            dst.bm.free(req.request_id)
        src.scheduler.sending_done(req, free=True)
        self.degraded_to_recompute += 1
        alive = dst.node_id not in self._dead and \
            self.controller.nodes[dst.node_id].alive
        target = dst if alive else src
        self.controller._stamp_failure(req, now, target.node_id,
                                       "transfer_retries_exhausted")
        req.reset_for_retry()
        req.prefill_node = target.node_id
        req.decode_node = target.node_id
        target.scheduler.enqueue_prefill(req)
        self._poke(target.node_id)

    def _start_transfer(self, req: Request, now: float) -> None:
        src = self.nodes[req.prefill_node]
        dst_id = req.decode_node if req.decode_node is not None else req.prefill_node
        # failover re-target: the routed decode node may have died while
        # the request prefilled
        if dst_id in self._dead or not self.controller.nodes[dst_id].alive:
            nd = self._pick_decode_node(exclude={dst_id})
            dst_id = nd if nd is not None else req.prefill_node
            req.decode_node = dst_id
        dst = self.nodes[dst_id]
        if not src.bm.owns(req.request_id):
            return   # request was drained/requeued (failover) mid-transfer
        if src is dst:
            # Role-flexible node serving both stages (degenerate routing):
            # the cache is already in this pool — local handoff, no transfer
            # (mirrors PDCluster._transfer).
            req.transfer_start = req.transfer_end = now
            req.transfer_calls = req.transfer_dispatches = 0
            if self.tracer is not None:
                self.tracer.emit(
                    req.request_id, "transfer",
                    start_cycle=now, end_cycle=now, node_id=src.node_id,
                    attrs={"schedule": "local", "calls": 0, "dispatches": 0,
                           "bytes": 0, "est_latency_s": 0.0})
            src.scheduler.sending_done(req, free=False)
            dst.scheduler.enqueue_decode(req)
            self._rehome_prefix(req, dst.node_id, dst.bm.get(req.request_id))
            self._poke(dst.node_id)
            return
        # Same TransferBackend registry as the real runtime: the "sim"
        # backend plans/prices exactly but its data plane is a no-op.
        backend = get_backend("sim", schedule=self.spec.schedule)
        try:
            job = backend.plan(req, src, dst)
        except OutOfBlocksError:
            # D pool full: requeue transfer shortly (backpressure). Anything
            # else (bad schedule, double registration) must surface.
            self.eq.push(now + 0.01, lambda: self._start_transfer(req, self.eq.now))
            return
        backend.execute(job, src, dst)
        # transfer faults, PRICED: the virtual data plane cannot corrupt real
        # bytes, so fail and corrupt verdicts are identical here — each failed
        # attempt adds its exponential backoff to the wire latency, and
        # exhausting every retry degrades to recompute-on-the-decode-node
        # (the same control path PDCluster takes with real checksums).
        penalty = 0.0
        exhausted = False
        if self.faults is not None:
            for attempt in range(self.transfer_max_retries + 1):
                fault = self.faults.transfer_attempt(now)
                if fault is None:
                    break
                req.transfer_retries += 1
                self.transfer_retry_count += 1
                backoff = self.transfer_backoff_s * (2.0 ** attempt)
                penalty += backoff
                if self.tracer is not None:
                    self.tracer.emit(
                        req.request_id, "transfer_retry",
                        start_cycle=now, end_cycle=now + backoff,
                        node_id=src.node_id,
                        attrs={"attempt": attempt, "fault": fault,
                               "backoff_s": backoff})
            else:
                exhausted = True
        if exhausted:
            self._degrade_to_recompute(req, src, dst, now)
            return
        profile = (self.spec.transfer_intra if self.same_host
                   else self.spec.transfer_inter)
        bw = self.faults.bandwidth_factor(now) if self.faults is not None \
            else 1.0
        latency = backend.price(job, profile) * bw
        hidden = 0.0
        windows = 1
        if self.layer_window > 0 and job.plan is not None and \
                job.plan.num_layers > self.layer_window:
            # Layer-window overlap, priced EXACTLY like the real cluster
            # (PDCluster._transfer_windowed): per-window sub-plan latencies
            # through the shared pipeline recurrence; only the spill past
            # the producing prefill tail is exposed.
            subs = job.plan.split_layer_windows(self.layer_window)
            lats = [sub.latency(profile) * bw for sub in subs]
            ends = [sub.layer_span[1] for sub in subs]
            L = job.plan.num_layers
            prefill_s = src.prefill_duration(
                req.last_prefill_chunk_tokens or req.prompt_len)
            latency, hidden = layer_window_overlap(lats, ends, L, prefill_s)
            job.num_calls = sum(sub.num_calls for sub in subs)
            job.num_dispatches = sum(sub.num_dispatches for sub in subs)
            windows = len(subs)
            if self.tracer is not None:
                t0 = now - prefill_s
                finish = 0.0
                for sub, lat in zip(subs, lats):
                    lo, hi = sub.layer_span
                    start_rel = max(finish, prefill_s * hi / L)
                    finish = start_rel + lat
                    self.tracer.emit(
                        req.request_id, "transfer_layer_window",
                        start_cycle=t0 + start_rel, end_cycle=t0 + finish,
                        node_id=src.node_id,
                        attrs={"layer_lo": lo, "layer_hi": hi,
                               "bytes": sub.total_bytes,
                               "est_latency_s": lat,
                               "hidden": finish <= prefill_s})
        latency += penalty   # retry backoffs are exposed wire time
        req.transfer_start = now
        req.transfer_calls = job.num_calls
        req.transfer_dispatches = job.num_dispatches
        self.transfer_latencies.append(latency)
        self.transfer_calls.append(job.num_calls)
        self.transfer_dispatches.append(job.num_dispatches)
        self.transfer_hidden.append(hidden)
        # sender-side compute blocked for a schedule-dependent share of the
        # EXPOSED transfer (per-call kernel contention; hidden windows ran
        # concurrently with compute that already paid for them)
        src.busy_until = max(src.busy_until, now) + \
            self.spec.transfer_blocking * latency

        def arrive():
            if req.state is not RequestState.SENDING:
                # drained (src death) or cancelled while on the wire: the
                # dst-side registration is a partial arrival — drop it
                # instead of billing blocks to a request that left
                if dst.bm.owns(req.request_id):
                    dst.bm.free(req.request_id)
                return
            if dst.node_id in self._dead or \
                    not self.controller.nodes[dst.node_id].alive:
                # dst died while the KV was in flight: free both sides and
                # requeue — recovery re-prefills token-exactly elsewhere
                if dst.bm.owns(req.request_id):
                    dst.bm.free(req.request_id)
                src.scheduler.sending_done(req, free=True)
                self.controller._stamp_failure(req, self.eq.now, dst.node_id,
                                               "dst_died_in_flight")
                req.reset_for_retry()
                self.controller.retry_queue.append(req)
                self._failure_check()   # reroute now (heartbeats refreshed)
                return
            req.transfer_end = self.eq.now
            if self.tracer is not None:
                self.tracer.emit(
                    req.request_id, "transfer",
                    start_cycle=req.transfer_start, end_cycle=self.eq.now,
                    node_id=src.node_id,
                    attrs={"schedule": job.schedule, "calls": job.num_calls,
                           "dispatches": job.num_dispatches,
                           "bytes": job.num_bytes, "est_latency_s": latency,
                           "hidden_s": hidden, "windows": windows,
                           "dst_node": dst.node_id,
                           "src_tp": src.tp, "dst_tp": dst.tp})
            # KV now lives on the decode node; the sending_done free below
            # invalidates the prefill-side entry (same as the real cluster)
            self._rehome_prefix(req, dst.node_id, job.dst_blocks)
            src.scheduler.sending_done(req)
            dst.scheduler.enqueue_decode(req)
            self._poke(dst.node_id)

        self.eq.push(now + latency, arrive)

    # -- run ---------------------------------------------------------------------------
    def run(self, requests: List[Request], t_max: float = 10_000.0) -> Dict[str, float]:
        if self.faults is not None:
            # rewind the injector (same instance re-runs identically) and put
            # its scheduled faults on the event clock: crashes kill at their
            # time; heartbeat-loss windows get a staleness check past the
            # timeout so detection fires even on an idle cluster.
            self.faults.reset()
            for spec in self.faults.crash_specs():
                self.eq.push(spec.at,
                             (lambda nid: lambda: self.kill_node(nid))(
                                 spec.node_id))
            for spec in self.faults.heartbeat_loss_specs():
                self.eq.push(spec.at + self.heartbeat_timeout + 1e-6,
                             self._failure_check)
        for req in requests:
            self.eq.push(req.arrival_time, (lambda r: (lambda: self._route(r)))(req))
        self.eq.run_until(t_max)
        total_tokens = sum(r.num_output for r in self.finished)
        span = max((r.finish_time for r in self.finished), default=1.0)
        e2e = [r.e2e() for r in self.finished if r.e2e() is not None]
        tpot = [t for t in (r.tpot() for r in self.finished) if t is not None]
        ttfts = sorted(t for t in (r.ttft() for r in self.finished)
                       if t is not None)
        p95 = ttfts[max(0, -(-len(ttfts) * 95 // 100) - 1)] if ttfts else 0.0
        starved = [n.node_id for n in self.nodes.values()
                   if n.served_prefill + n.served_decode == 0]
        return {
            "system": self.kind,
            "routing": self.routing,
            "offered": self.offered,
            "rejected": len(self.rejected),
            # prefix-reuse plane (priced identically to the real engine:
            # hits shrink the prefill chunks the duration model sees)
            "prefill_tokens_computed": sum(
                n.prefill_tokens_computed for n in self.nodes.values()),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "prefix_fetches": self.prefix_fetches,
            "mean_prefix_fetch_dispatches": (
                sum(self.prefix_fetch_dispatches) / len(self.prefix_fetch_dispatches)
                if self.prefix_fetch_dispatches else 0.0),
            "p95_ttft_s": p95,
            "starved_nodes": len(starved),
            "finished": len(self.finished),
            "throughput_tok_s": total_tokens / span if span else 0.0,
            "mean_e2e_s": sum(e2e) / len(e2e) if e2e else 0.0,
            "mean_tpot_s": sum(tpot) / len(tpot) if tpot else 0.0,
            "mean_transfer_s": (sum(self.transfer_latencies) / len(self.transfer_latencies)
                                if self.transfer_latencies else 0.0),
            "mean_transfer_calls": (sum(self.transfer_calls) / len(self.transfer_calls)
                                    if self.transfer_calls else 0.0),
            "mean_transfer_dispatches": (
                sum(self.transfer_dispatches) / len(self.transfer_dispatches)
                if self.transfer_dispatches else 0.0),
            # layer-window overlap: wire time hidden behind prefill compute;
            # mean_transfer_s above is the EXPOSED remainder
            "transfer_hidden_s": sum(self.transfer_hidden),
            "transfer_hidden_frac": (
                sum(self.transfer_hidden)
                / (sum(self.transfer_hidden) + sum(self.transfer_latencies))
                if self.transfer_hidden and
                (sum(self.transfer_hidden) + sum(self.transfer_latencies)) > 0
                else 0.0),
            "events": len(self.controller.events),
            # mesh-parallel topology (same keys as PDCluster.stats)
            "sharded_nodes": sum(1 for n in self.nodes.values() if n.tp > 1),
            "max_tp_degree": max(
                (n.tp for n in self.nodes.values()), default=1),
            # tier plane (same keys as PDCluster.stats)
            "tier_demoted_blocks": sum(
                t.demoted_blocks for t in self.tiers.values()),
            "tier_promoted_blocks": sum(
                t.promoted_blocks for t in self.tiers.values()),
            "tier_host_resident": sum(
                t.host.num_resident for t in self.tiers.values()),
            "cached_reused": sum(
                n.bm.cached_reused for n in self.nodes.values()),
            "cached_evicted": sum(
                n.bm.cached_evicted for n in self.nodes.values()),
            # fault plane (same keys as PDCluster.stats)
            "fault_kills": self.fault_kills,
            "transfer_retries": self.transfer_retry_count,
            "degraded_to_recompute": self.degraded_to_recompute,
            "recoveries": self.recoveries,
            "leaked_blocks": float(self.audit_blocks()),
        }

    # -- leak auditing ------------------------------------------------------------------
    def live_request_ids(self) -> set:
        """Cluster-wide live set (see PDCluster.live_request_ids): a SENDING
        request's dst registration lives on the destination bm while the
        request queues on the source."""
        live = set()
        for node in self.nodes.values():
            s = node.scheduler
            for sub in (s.prefill, s.decode):
                for q in (sub.waiting, sub.running, sub.swapped, sub.sending):
                    live.update(r.request_id for r in q)
        live.update(r.request_id for r in self.controller.retry_queue)
        live.update(r.request_id for r in self.controller.deferred)
        return live

    def audit_blocks(self) -> int:
        """Count leaked block tables fleet-wide (0 on a healthy run)."""
        live = self.live_request_ids()
        leaked = 0
        for node in self.nodes.values():
            node.bm.check_invariants()
            tm = self.tiers.get(node.node_id)
            if tm is not None and node.node_id not in self._dead:
                tm.check_invariants()
            leaked += sum(1 for rid in node.bm._table if rid not in live)
        return leaked

    def assert_no_leaks(self) -> None:
        """Hard audit (tests / chaos gate): raise on any leaked table."""
        live = self.live_request_ids()
        for node in self.nodes.values():
            node.bm.assert_no_leaks(live)
