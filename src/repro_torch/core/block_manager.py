"""Control-plane block manager: request -> physical block ids.

One per node, shared between that node's prefill and decode schedulers (the
paper's hybrid scheduler "share[s] a block manager"). The data-plane pool
(the device array holding pages) lives in ``serving/kv_cache.py`` and is
indexed by the ids handed out here.

Blocks are **ref-counted** so a prefix-cache hit can share the matched
prefix's blocks into a new request's table instead of copying them
(``allocate(..., prefix_blocks=...)``). The sharing rules:

* only FULL blocks are ever shared (the prefix index matches at block
  granularity), so a shared block is read-only by construction — writes
  land at token positions past the shared prefix, i.e. in blocks the
  request owns exclusively;
* a block whose refcount reaches zero is NOT returned to the allocator —
  it parks in an **LRU demotion queue** (``_cached``). Its KV pages stay
  valid (nothing reallocates them), so a prefix re-requested one cycle
  after its last holder finished still hits instead of recomputing from
  scratch. Cached blocks are reclaimed lazily under capacity pressure,
  oldest first; ``on_evict`` fires just before a reclaim so the tier plane
  can demote index-backed blocks to host DRAM instead of losing them, and
  ``on_free`` fires with exactly the physically-freed blocks — the prefix
  index hangs its HBM residency invalidation off this hook, so it can
  never advertise pool KV whose pages were recycled.

``check_invariants`` audits the bookkeeping: per-block refcounts must equal
the number of tables holding the block, the cached and refcounted sets must
be disjoint, and free + tabled + cached must tile the pool exactly.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.allocator import OutOfBlocksError, make_allocator
from repro_torch.core.segments import blocks_to_segments, fragmentation


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int, allocator: str = "flowkv"):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.allocator = make_allocator(allocator, num_blocks)
        self._table: Dict[int, List[int]] = {}   # request_id -> block ids (ordered)
        self._refcount: Dict[int, int] = {}      # block id -> holding tables
        # Refcount-zero blocks parked for reuse, oldest-freed first (LRU).
        # Still "allocated" from the allocator's point of view; their pages
        # hold the KV they held when their last table dropped them.
        self._cached: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        # Fired with the block ids that PHYSICALLY freed (pages recycled).
        # serving/cluster.py and sim/cluster_sim.py wire this to
        # ``GlobalPrefixIndex.invalidate_blocks`` so stale HBM residency is
        # impossible by construction.
        self.on_free: Optional[Callable[[List[int]], None]] = None
        # Fired with cached blocks chosen for reclaim, BEFORE they free —
        # their pages are still intact here. The tier plane demotes
        # index-backed blocks to the host tier in this window; on_free then
        # invalidates whatever still advertises these pool blocks.
        self.on_evict: Optional[Callable[[List[int]], None]] = None
        # Trajectory counters for the cache itself.
        self.cached_reused = 0       # cached blocks revived into a table
        self.cached_evicted = 0      # cached blocks reclaimed under pressure

    # -- capacity ---------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return self.allocator.num_free

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def free_capacity(self) -> int:
        """Blocks obtainable right now: free pool + reclaimable LRU cache."""
        return self.allocator.num_free + len(self._cached)

    @property
    def utilization(self) -> float:
        """KV_u in the paper's load vector. Cached blocks are reclaimable on
        demand, so they count as free — a node full of cold cached prefixes
        must not look loaded to the router."""
        return 1.0 - self.free_capacity / self.num_blocks

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def can_allocate(self, num_tokens: int, shared_blocks: int = 0,
                     shared_block_ids: Optional[Sequence[int]] = None) -> bool:
        """Room for ``num_tokens``, of which ``shared_blocks`` full blocks
        come from a prefix-cache hit (shared or revived, not drawn from the
        free pool). Pass ``shared_block_ids`` for exact accounting: a shared
        block that is itself parked in the cache is revived, so it neither
        consumes a fresh block nor counts as reclaimable."""
        if shared_block_ids is not None:
            shared = {int(b) for b in shared_block_ids}
            reclaimable = len(self._cached.keys() - shared)
            return (self.blocks_needed(num_tokens) - len(shared)
                    <= self.allocator.num_free + reclaimable)
        # count-only callers: assume the worst (every shared block cached)
        reclaimable = max(0, len(self._cached) - shared_blocks)
        return (self.blocks_needed(num_tokens) - shared_blocks
                <= self.allocator.num_free + reclaimable)

    # -- cache reclaim ------------------------------------------------------------
    def _evict(self, blocks: List[int]) -> None:
        """Physically free cache-evicted blocks (on_evict -> free -> on_free)."""
        if not blocks:
            return
        self.cached_evicted += len(blocks)
        if self.on_evict is not None:
            self.on_evict(list(blocks))
        self.allocator.free(blocks)
        if self.on_free is not None:
            self.on_free(list(blocks))

    def _max_free_segment(self) -> int:
        """Longest contiguous free run (= num_free on the freelist baseline,
        where contiguity is moot)."""
        segs = getattr(self.allocator, "free_segments", None)
        if segs is None:
            return self.allocator.num_free
        return max((s.length for s in segs()), default=0)

    def _ensure_free(self, n: int) -> None:
        """Reclaim LRU-oldest cached blocks until ``n`` are free (best effort).

        Under the segment allocator this also chases CONTIGUITY, not just
        count: a pool left sufficient-but-fragmented by scattered cache holes
        defeats the merged-transfer win (paper §3.3), so reclaim continues —
        freed neighbours coalesce — until one free segment covers the
        request or the cache runs dry. Caching therefore only retains blocks
        the pool has genuine slack for, which is exactly the intended
        "until capacity pressure" policy.
        """
        deficit = n - self.allocator.num_free
        evict: List[int] = []
        while self._cached and deficit > 0:
            b, _ = self._cached.popitem(last=False)
            evict.append(b)
            deficit -= 1
        self._evict(evict)
        if n <= 1:
            return
        while self._cached and self._max_free_segment() < n:
            b, _ = self._cached.popitem(last=False)
            self._evict([b])

    def reclaim_cache(self, n: Optional[int] = None) -> List[int]:
        """Force-reclaim up to ``n`` (default: all) cached blocks, LRU first.

        The node-teardown and test paths; ordinary pressure reclaims lazily
        inside allocate/extend."""
        limit = len(self._cached) if n is None else min(n, len(self._cached))
        evict = [self._cached.popitem(last=False)[0] for _ in range(limit)]
        self._evict(evict)
        return evict

    def drop_cache(self) -> List[int]:
        """Free every cached block WITHOUT the demotion hook (node death:
        the host tier dies with the node, so there is nowhere to demote to).
        ``on_free`` still fires so index residency is invalidated."""
        blocks = list(self._cached)
        self._cached.clear()
        if blocks:
            self.allocator.free(blocks)
            if self.on_free is not None:
                self.on_free(list(blocks))
        return blocks

    def drop_cached(self, blocks: Sequence[int]) -> None:
        """Physically free SPECIFIC cached blocks without the demotion hook
        (``on_free`` still fires). For blocks whose pages hold nothing worth
        saving — e.g. ``take_for_cache`` surplus a promotion never filled."""
        drop = [int(b) for b in blocks]
        for b in drop:
            if b not in self._cached:
                raise ValueError(f"block {b} is not cached")
            del self._cached[b]
        if drop:
            self.allocator.free(drop)
            if self.on_free is not None:
                self.on_free(list(drop))

    def take_for_cache(self, n: int) -> List[int]:
        """Allocate ``n`` fresh blocks straight into the LRU cache.

        Promotion destinations: host-tier KV lands in blocks that belong to
        no request yet; the index re-points at them and a later
        ``allocate(prefix_blocks=...)`` revives them like any cached hit."""
        if n <= 0:
            return []
        if n > self.free_capacity:
            raise OutOfBlocksError(
                f"requested {n} blocks, only {self.free_capacity} obtainable")
        self._ensure_free(n)
        new = self.allocator.allocate(n)
        for b in new:
            self._cached[b] = None
        return new

    # -- request ops --------------------------------------------------------------
    def allocate(self, request_id: int, num_tokens: int,
                 prefix_blocks: Sequence[int] = ()) -> List[int]:
        """Build a request's block table.

        With ``prefix_blocks`` (a prefix-cache hit), those blocks are SHARED
        — live donors get a refcount bump, cached blocks are revived out of
        the LRU queue — and they become the head of the table; only the
        remaining suffix blocks are drawn from the allocator.
        """
        if request_id in self._table:
            raise ValueError(f"request {request_id} already has blocks")
        prefix = [int(b) for b in prefix_blocks]
        revive = []
        for b in prefix:
            if b in self._refcount:
                continue
            if b in self._cached:
                revive.append(b)
            else:
                raise ValueError(f"prefix block {b} is not allocated")
        fresh = self.blocks_needed(num_tokens) - len(prefix)
        if fresh < 0:
            raise ValueError(
                f"{len(prefix)} prefix blocks exceed the {num_tokens}-token table")
        if fresh > self.allocator.num_free + (len(self._cached) - len(revive)):
            raise OutOfBlocksError(
                f"requested {fresh} blocks, only {self.allocator.num_free} free "
                f"(+{len(self._cached) - len(revive)} reclaimable)")
        for b in revive:
            del self._cached[b]
        self.cached_reused += len(revive)
        new: List[int] = []
        if fresh:
            self._ensure_free(fresh)
            new = self.allocator.allocate(fresh)
        blocks = prefix + new
        for b in blocks:
            self._refcount[b] = self._refcount.get(b, 0) + 1
        self._table[request_id] = blocks
        return blocks

    def register(self, request_id: int, num_tokens: int) -> List[int]:
        """Allocate space on a *destination* node ahead of a KV transfer."""
        return self.allocate(request_id, num_tokens)

    def ensure_capacity(self, request_id: int, num_tokens: int) -> List[int]:
        """Grow a request's table to cover ``num_tokens``; returns new blocks.

        Used when a remote prefix fetch landed the prefix blocks ahead of
        admission: the scheduler tops the table up to the full prompt.
        """
        blocks = self._table[request_id]
        extra = self.blocks_needed(num_tokens) - len(blocks)
        if extra <= 0:
            return []
        self._ensure_free(extra)
        new = self.allocator.extend(blocks, extra)
        for b in new:
            self._refcount[b] = self._refcount.get(b, 0) + 1
        blocks.extend(new)
        return new

    def append_token(self, request_id: int, total_tokens: int) -> Optional[int]:
        """Ensure capacity for one more token; returns a new block id if grown."""
        blocks = self._table[request_id]
        needed = self.blocks_needed(total_tokens)
        if needed <= len(blocks):
            return None
        assert needed == len(blocks) + 1, "decode grows one block at a time"
        self._ensure_free(1)
        new = self.allocator.extend(blocks, 1)
        self._refcount[new[0]] = self._refcount.get(new[0], 0) + 1
        blocks.extend(new)
        return new[0]

    def free(self, request_id: int) -> None:
        """Drop a request's table; refcount-zero blocks park in the LRU cache.

        NOT a physical free: the pages stay intact and index entries stay
        valid, so a prefix re-requested after its last holder released it
        re-hits instead of recomputing (it is revived by the next
        ``allocate``). Physical frees happen only at reclaim time.
        """
        blocks = self._table.pop(request_id, None)
        if not blocks:
            return
        for b in blocks:
            n = self._refcount[b] - 1
            if n:
                self._refcount[b] = n
            else:
                del self._refcount[b]
                self._cached[b] = None       # newest at the MRU end

    def release_all(self) -> List[int]:
        """Free every request's blocks AND the cache (node death / teardown).

        Returns the request ids that held blocks. Safe to run before or
        after the controller's failure drain — ``free`` tolerates both
        orders.
        """
        rids = list(self._table)
        for rid in rids:
            self.free(rid)
        self.drop_cache()
        return rids

    def get(self, request_id: int) -> List[int]:
        return list(self._table[request_id])

    def owns(self, request_id: int) -> bool:
        return request_id in self._table

    def block_alive(self, block_id: int) -> bool:
        """True while the block's pages hold valid KV: held by some table OR
        parked in the LRU cache (cached blocks are revivable hits)."""
        return block_id in self._refcount or block_id in self._cached

    def is_cached(self, block_id: int) -> bool:
        return block_id in self._cached

    def cached_blocks(self) -> List[int]:
        """Cache contents, LRU-oldest first (the reclaim order)."""
        return list(self._cached)

    def refcount(self, block_id: int) -> int:
        return self._refcount.get(block_id, 0)

    # -- diagnostics -----------------------------------------------------------------
    def request_fragmentation(self, request_id: int) -> float:
        return fragmentation(blocks_to_segments(self._table[request_id]))

    def mean_fragmentation(self) -> float:
        if not self._table:
            return 0.0
        return sum(self.request_fragmentation(r) for r in self._table) / len(self._table)

    def check_invariants(self) -> None:
        self.allocator.check_invariants()
        counts: collections.Counter = collections.Counter()
        for rid, blocks in self._table.items():
            bs = set(blocks)
            assert len(bs) == len(blocks), f"duplicate blocks for request {rid}"
            counts.update(bs)
        # refcounts mirror table membership exactly: a block held by k tables
        # has refcount k; refcount 1 = exclusive (writable), > 1 = shared
        # prefix (read-only). No table block may be unaccounted and no
        # refcount may outlive its holders.
        assert dict(counts) == self._refcount, (
            f"refcount drift: tables={dict(counts)} refcounts={self._refcount}")
        # disjoint and exhaustive: every pool block is exactly one of
        # free-in-allocator, held by >= 1 table, or parked in the LRU cache.
        overlap = self._cached.keys() & self._refcount.keys()
        assert not overlap, f"blocks both cached and refcounted: {sorted(overlap)}"
        accounted = (self.allocator.num_free + len(set(counts))
                     + len(self._cached))
        assert accounted == self.num_blocks, (
            f"pool not tiled: free={self.allocator.num_free} "
            f"tabled={len(set(counts))} cached={len(self._cached)} "
            f"!= {self.num_blocks}")

    def assert_no_leaks(self, live_request_ids) -> None:
        """Fault-path audit: beyond the structural invariants, every table
        must belong to a request the cluster still considers live — a table
        for a finished/failed/cancelled request is a leaked allocation (the
        kill-mid-transfer bug class: partially-written dst blocks billed as
        valid after their request was requeued elsewhere). Cached blocks are
        NOT leaks: they belong to no request by design."""
        self.check_invariants()
        live = set(live_request_ids)
        leaked = [rid for rid in self._table if rid not in live]
        assert not leaked, (
            f"leaked block tables for dead requests {leaked}: "
            f"{ {rid: self._table[rid] for rid in leaked} }")


__all__ = ["BlockManager", "OutOfBlocksError"]
