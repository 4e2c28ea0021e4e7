"""Per-node host-DRAM KV tier behind the paged HBM pool. Port of
``repro/serving/host_tier.py``.

The Mooncake/KVCache-centric move (PAPERS.md): the blocks worth keeping are
exactly the long shared prefixes that capacity pressure evicts first, so a
refcount-zero pool block whose pages back a :class:`GlobalPrefixIndex` entry
is **demoted** — copied to a host-DRAM pool in one fused descriptor-table
dispatch — instead of dying with its pages. A later hit on that prefix
**promotes** it back (one host->HBM dispatch) and the unchanged PR 5 sharing
machinery takes over.

Two classes:

* :class:`HostTier` — the DRAM pool itself: a second ``KVCacheSpec`` pool in
  its own block namespace (``dataclasses.replace(spec, num_blocks=...)`` —
  the transfer engine only requires the two specs to agree on per-block
  payload and layer count, so host and device pools may differ in size), a
  freelist allocator, and an LRU over resident host blocks so the tier
  self-evicts when full. ``with_pool=False`` is the simulator mode: full
  bookkeeping and plan/dispatch accounting with no backing array.
* :class:`TierManager` — the policy glue shared VERBATIM by ``PDCluster``
  and ``ClusterSim`` (tier decisions and span sequences match across
  runtimes by construction, not by parallel reimplementation). It hangs off
  ``BlockManager.on_evict``: inside the eviction window (pages still
  intact) it filters the victims to index-backed blocks, copies them
  host-ward as ONE fused plan, and re-points their index entries pool->host
  *before* ``on_free`` runs — so the HBM invalidation pass finds nothing to
  kill and the entries survive in the DRAM tier.

Movement is **move semantics**, not copies: a demoted block's KV lives only
in its host block, a promoted block's KV only in its (cached) pool block.
Every block of KV is thus in exactly one tier at all times — the
disjoint-and-exhaustive invariant the property suite audits.

On a GPU node the host pool is pinned host memory, and each direction is
one launch of K1 over it (``kernels/kv_gather/ops.kv_transfer``'s host
route); the launch is asynchronous, so a CPU read of ``HostTier.pool``
after a demotion synchronizes the stream first. Where the reference rebinds
``host.pool`` to the executor's result, the port's executor writes in
place, so the pool keeps its storage.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import layout as L
from repro_torch.core.allocator import OutOfBlocksError
from repro_torch.core.block_manager import BlockManager
from repro_torch.core.transfer import TransferEngine, TransferPlanner
from repro_torch.serving.prefix_cache import GlobalPrefixIndex, TIER_DRAM


def _host_pool(spec: L.KVCacheSpec, device) -> torch.Tensor:
    if device is not None and torch.device(device).type == "cuda":
        return torch.empty(spec.shape, dtype=spec.dtype, pin_memory=True)
    return L.alloc_cache(spec, "cpu")


class HostTier:
    """A host-DRAM paged pool: spec + array + freelist + LRU.

    Host blocks live in their OWN id namespace (0..num_blocks-1, distinct
    from pool block ids); the prefix index tags every entry with its tier,
    so the two namespaces never mix.
    """

    def __init__(self, spec: L.KVCacheSpec, num_blocks: int,
                 with_pool: bool = True, device=None):
        self.device_spec = spec
        # spec may be None only for a disabled (num_blocks=0) tier — e.g. a
        # simulator node constructed without a KV spec.
        self.spec = (None if spec is None else
                     dataclasses.replace(spec, num_blocks=max(num_blocks, 1)))
        self.num_blocks = int(num_blocks)
        # In the real runtime this tensor is the DRAM pool: pinned host
        # memory beside a node whose pool is on a GPU (``device``), a plain
        # CPU tensor beside a CPU node. The simulator passes
        # with_pool=False: all bookkeeping, no bytes.
        self.pool = (_host_pool(self.spec, device)
                     if with_pool and num_blocks else None)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # oldest first

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_resident(self) -> int:
        return len(self._lru)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocksError(
                f"requested {n} host blocks, only {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._lru[b] = None
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            b = int(b)
            if b not in self._lru:
                raise ValueError(f"host block {b} is not allocated")
            del self._lru[b]
            self._free.append(b)

    def touch(self, block: int) -> None:
        """Move a resident block to the MRU end (it is about to matter)."""
        b = int(block)
        if b in self._lru:
            self._lru.move_to_end(b)

    def evict_lru(self, n: int) -> List[int]:
        """Free the ``n`` oldest resident blocks; returns their ids.

        The caller owns index invalidation for the victims — the tier does
        not know what its blocks advertise.
        """
        n = min(n, len(self._lru))
        out = [self._lru.popitem(last=False)[0] for _ in range(n)]
        self._free.extend(out)
        return out

    def clear(self) -> List[int]:
        """Node death: every resident block dies with the node."""
        out = list(self._lru)
        self._lru.clear()
        self._free = list(range(self.num_blocks - 1, -1, -1))
        return out

    def check_invariants(self) -> None:
        free = set(self._free)
        resident = set(self._lru)
        assert len(free) == len(self._free), "duplicate free host blocks"
        assert not (free & resident), (
            f"host blocks both free and resident: {sorted(free & resident)}")
        assert len(free) + len(resident) == self.num_blocks, (
            f"host tier not tiled: free={len(free)} resident={len(resident)} "
            f"!= {self.num_blocks}")


class TierManager:
    """Demotion/promotion policy for one node, shared by both runtimes.

    Wired as ``bm.on_evict``; the owning runtime supplies ``get_tracer`` /
    ``get_clock`` thunks (read at emission time, like every other span
    producer) so :func:`repro_torch.obs.tracing.attach_tracer` keeps working on
    already-constructed clusters.
    """

    def __init__(self, node_id: int, bm: BlockManager,
                 index: GlobalPrefixIndex, spec: L.KVCacheSpec,
                 host_blocks: int, *, kv=None, schedule: str = "flowkv",
                 get_tracer: Optional[Callable[[], object]] = None,
                 get_clock: Optional[Callable[[], float]] = None):
        self.node_id = node_id
        self.bm = bm
        self.index = index
        self.spec = spec
        self.kv = kv               # PagedKVCache, or None in the simulator
        self.schedule = schedule
        self.host = HostTier(spec, host_blocks, with_pool=kv is not None,
                             device=None if kv is None else kv.device)
        self.planner = TransferPlanner(spec)
        self._demote_engine = (TransferEngine(spec, self.host.spec)
                               if kv is not None and host_blocks else None)
        self._promote_engine = (TransferEngine(self.host.spec, spec)
                                if kv is not None and host_blocks else None)
        self._get_tracer = get_tracer or (lambda: None)
        self._get_clock = get_clock or (lambda: 0.0)
        # trajectory counters
        self.demoted_blocks = 0
        self.promoted_blocks = 0
        self.demote_dispatches = 0
        self.promote_dispatches = 0
        self.host_evicted_blocks = 0
        self.last_promote_latency_s = 0.0

    @property
    def enabled(self) -> bool:
        return self.host.num_blocks > 0

    def attach(self) -> "TierManager":
        """Hook into the block manager's eviction window, and into the
        index's orphan notification (a re-insert that re-points a digest
        away from its DRAM backing must free the host block, or it squats
        resident-but-unbacked forever)."""
        self.bm.on_evict = self.on_evict
        self.index.on_host_orphan[self.node_id] = self.host.free
        return self

    # -- demotion (bm.on_evict) ---------------------------------------------------
    def on_evict(self, blocks: List[int]) -> None:
        """Cache-evicted pool blocks, pages still intact: demote the
        index-backed ones to host DRAM as one fused plan."""
        if not self.enabled:
            return
        demotable = [b for b in blocks
                     if self.index.backed_block(self.node_id, b)]
        if not demotable:
            return
        want = len(demotable)
        if self.host.num_free < want:
            victims = self.host.evict_lru(want - self.host.num_free)
            if victims:
                self.host_evicted_blocks += len(victims)
                self.index.invalidate_host_blocks(self.node_id, victims)
        take = min(want, self.host.num_free)
        if take == 0:
            return
        # the eviction list arrives LRU-oldest-first; when the host tier
        # cannot hold everything, keep the most recently used tail
        demotable = demotable[-take:]
        host_blocks = self.host.allocate(take)
        plan = self.planner.plan(self.schedule, demotable, host_blocks)
        start = self._stamp()
        if self._demote_engine is not None:
            self._demote_engine.execute(plan, self.kv.pool, self.host.pool)
        self.demote_dispatches += 1
        for pb, hb in zip(demotable, host_blocks):
            self.index.demote_block(self.node_id, pb, hb)
        self.demoted_blocks += take
        self._emit("tier_demote", -1, start, num_blocks=take)

    # -- promotion ---------------------------------------------------------------
    def dram_match_blocks(self, tokens: Sequence[int]) -> List[int]:
        """Host blocks backing this prompt's matched chain on this node."""
        m = self.index.lookup(self.node_id, tokens)
        return [b for b, t in zip(m.block_ids, m.tiers) if t == TIER_DRAM]

    def promote_match(self, tokens: Sequence[int], trace_id: int = -1,
                      profile=None) -> int:
        """Promote every DRAM block in this prompt's matched chain back to
        (cached) pool blocks; returns the number of blocks promoted.

        Promotion destinations come from ``bm.take_for_cache`` — they belong
        to no request, so the admission path revives them exactly like any
        other cached hit and the leak audit needs no special cases. Taking
        pool blocks can itself trigger demotion (``_ensure_free`` ->
        ``on_evict``); the targets are touched to the host MRU end first so
        that cascade cannot evict what it is about to promote unless the
        tier is pathologically small — any target it does lose is dropped
        from the (chain-order) run before the copy.
        """
        if not self.enabled:
            return 0
        targets = self.dram_match_blocks(tokens)
        if not targets:
            return 0
        for hb in targets:
            self.host.touch(hb)
        n = min(len(targets), self.bm.free_capacity)
        if n == 0:
            return 0
        pool_blocks = self.bm.take_for_cache(n)
        # re-validate after the take: a demotion cascade may have evicted
        # host blocks. Keep the leading chain-order run that survived.
        alive: List[int] = []
        for hb in targets[:n]:
            if not self.index.backed_block(self.node_id, hb, tier=TIER_DRAM):
                break
            alive.append(hb)
        if len(alive) < len(pool_blocks):
            # surplus destinations go straight back: reclaim without the
            # demotion hook (they hold no KV yet, nothing to save)
            self.bm.drop_cached(pool_blocks[len(alive):])
            pool_blocks = pool_blocks[:len(alive)]
        if not alive:
            return 0
        plan = self.planner.plan(self.schedule, alive, pool_blocks)
        start = self._stamp()
        if self._promote_engine is not None:
            self.kv.import_plan(self._promote_engine, plan, self.host.pool)
        self.promote_dispatches += 1
        for hb, pb in zip(alive, pool_blocks):
            self.index.promote_entry(self.node_id, hb, pb)
        self.host.free(alive)
        self.promoted_blocks += len(alive)
        self.last_promote_latency_s = (plan.latency(profile)
                                       if profile is not None else 0.0)
        self._emit("tier_promote", trace_id, start, num_blocks=len(alive))
        return len(alive)

    # -- teardown ----------------------------------------------------------------
    def clear(self) -> None:
        """Node death: the host tier dies with the node."""
        victims = self.host.clear()
        if victims:
            self.index.invalidate_host_blocks(self.node_id, victims)

    # -- audits / stats ----------------------------------------------------------
    def check_invariants(self) -> None:
        self.host.check_invariants()
        # every resident host block backs exactly one index entry, and every
        # DRAM entry points at a resident host block (no phantom residency)
        backed = self.index._node_host_blocks.get(self.node_id, {})
        resident = set(self.host._lru)
        assert set(backed) == resident, (
            f"host tier / index drift on node {self.node_id}: "
            f"backed={sorted(backed)} resident={sorted(resident)}")

    def stats(self) -> Dict[str, int]:
        return {
            "host_blocks": self.host.num_blocks,
            "host_resident": self.host.num_resident,
            "demoted_blocks": self.demoted_blocks,
            "promoted_blocks": self.promoted_blocks,
            "demote_dispatches": self.demote_dispatches,
            "promote_dispatches": self.promote_dispatches,
            "host_evicted_blocks": self.host_evicted_blocks,
        }

    # -- span plumbing -----------------------------------------------------------
    def _stamp(self) -> float:
        return self._get_clock()

    def _emit(self, name: str, trace_id: int, start: float, **attrs) -> None:
        tracer = self._get_tracer()
        if tracer is None:
            return
        tracer.emit(trace_id, name, start_cycle=start,
                    end_cycle=self._get_clock(), node_id=self.node_id,
                    attrs=dict(attrs))


__all__ = ["HostTier", "TierManager"]
