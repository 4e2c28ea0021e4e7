"""Block allocators for paged KV caches.

Two allocators, matching the paper's baseline/optimized pair:

* :class:`BlockAllocator` — the vLLM-style baseline: a LIFO free list of
  individual block ids. Under churn this scatters a request's blocks across
  the pool, which is exactly what makes block-wise KV transfer slow.

* :class:`SegmentAllocator` — FlowKV §3.3: free space is tracked as
  *segments* (runs of consecutive blocks) in size-bucketed min-heaps.
  Allocation is best-fit ("chooses the right segments ... to minimize
  waste"), preferring a single segment that covers the whole request;
  deallocation merges adjacent free segments ("merges adjacent free segments
  during deallocation to boost future allocation efficiency").

Both expose the same interface so the block manager / benchmarks can swap
them, and both are pure-Python control-plane objects — the data plane (the
actual KV pages) lives in device memory managed by ``serving/kv_cache.py``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

from repro_torch.core.segments import Segment, blocks_to_segments, segments_to_blocks


class OutOfBlocksError(RuntimeError):
    """Raised when an allocation cannot be satisfied."""


class BlockAllocator:
    """Baseline vLLM-style free-list allocator (block granularity, LIFO)."""

    name = "freelist"

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.num_blocks = num_blocks
        # LIFO free list: freshly freed (scattered) blocks are reused first,
        # replicating the fragmentation behaviour of block-level allocators.
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._allocated: set[int] = set()

    # -- interface -----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n <= 0:
            raise ValueError("allocation size must be positive")
        if n > len(self._free):
            raise OutOfBlocksError(f"requested {n} blocks, only {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        return out

    def extend(self, block_ids: Sequence[int], n: int) -> List[int]:
        """Allocate ``n`` more blocks for an existing request (decode growth)."""
        del block_ids  # baseline ignores existing placement
        return self.allocate(n)

    def free(self, block_ids: Sequence[int]) -> None:
        for b in block_ids:
            if b not in self._allocated:
                raise ValueError(f"double free of block {b}")
            self._allocated.remove(b)
            self._free.append(b)

    def check_invariants(self) -> None:
        assert len(self._free) + len(self._allocated) == self.num_blocks
        assert not (set(self._free) & self._allocated)


class _SegmentHeaps:
    """Size-bucketed min-heaps over free segments.

    Buckets are power-of-two size classes; each bucket is a heap ordered by
    (length, start) so ``pop_best_fit`` returns the smallest segment that
    fits, lowest-addressed first. Stale entries (segments that have since
    been merged or split) are lazily discarded via a generation map.
    """

    def __init__(self) -> None:
        self._buckets: Dict[int, List[Segment]] = {}
        self._live: set[Segment] = set()

    @staticmethod
    def _bucket_of(length: int) -> int:
        return max(0, length.bit_length() - 1)

    def add(self, seg: Segment) -> None:
        self._live.add(seg)
        heapq.heappush(self._buckets.setdefault(self._bucket_of(seg.length), []), seg)

    def discard(self, seg: Segment) -> None:
        # Lazy removal: just mark dead; heaps skip dead entries on pop.
        self._live.discard(seg)

    def pop_best_fit(self, n: int) -> Optional[Segment]:
        """Smallest live segment with length >= n, or None."""
        best: Optional[Segment] = None
        start_bucket = self._bucket_of(n)
        for bucket_id in sorted(self._buckets):
            if bucket_id < start_bucket:
                continue
            heap = self._buckets[bucket_id]
            # Drop dead entries from the top.
            while heap and heap[0] not in self._live:
                heapq.heappop(heap)
            if not heap:
                continue
            cand = heap[0]
            if cand.length >= n and (best is None or (cand.length, cand.start) < (best.length, best.start)):
                best = cand
            if best is not None and bucket_id > self._bucket_of(best.length):
                break  # later buckets only hold larger segments
        if best is not None:
            self._live.discard(best)
            # Leave the heap entry; it is dead now and will be skipped later.
        return best

    def pop_largest(self) -> Optional[Segment]:
        best: Optional[Segment] = None
        for heap in self._buckets.values():
            for seg in heap:
                if seg in self._live and (best is None or seg.length > best.length):
                    best = seg
        if best is not None:
            self._live.discard(best)
        return best

    def live_segments(self) -> List[Segment]:
        return sorted(self._live)

    def __len__(self) -> int:
        return len(self._live)


class SegmentAllocator:
    """FlowKV segment allocator: best-fit over min-heaps, merge on free."""

    name = "flowkv-segment"

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.num_blocks = num_blocks
        self._heaps = _SegmentHeaps()
        self._heaps.add(Segment(0, num_blocks))
        # start -> segment and end -> segment maps for O(1) merge on free.
        self._by_start: Dict[int, Segment] = {0: Segment(0, num_blocks)}
        self._by_end: Dict[int, Segment] = {num_blocks: Segment(0, num_blocks)}
        self._num_free = num_blocks
        self._allocated: set[int] = set()

    # -- bookkeeping ---------------------------------------------------------
    def _insert_free(self, seg: Segment) -> None:
        self._heaps.add(seg)
        self._by_start[seg.start] = seg
        self._by_end[seg.end] = seg

    def _remove_free(self, seg: Segment) -> None:
        self._heaps.discard(seg)
        del self._by_start[seg.start]
        del self._by_end[seg.end]

    # -- interface -----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return self._num_free

    def allocate(self, n: int) -> List[int]:
        """Allocate ``n`` blocks in as few contiguous segments as possible.

        Strategy (paper §3.3): try a single best-fit segment first; when the
        pool is too fragmented for that, repeatedly take the largest free
        segments (each one stays a contiguous run for the request).
        """
        if n <= 0:
            raise ValueError("allocation size must be positive")
        if n > self._num_free:
            raise OutOfBlocksError(f"requested {n} blocks, only {self._num_free} free")

        out_segments: List[Segment] = []
        remaining = n
        seg = self._heaps.pop_best_fit(remaining)
        if seg is not None:
            self._remove_or_split(seg, remaining, out_segments)
            remaining = 0
        while remaining > 0:
            seg = self._heaps.pop_largest()
            assert seg is not None, "num_free accounting broken"
            take = min(seg.length, remaining)
            self._remove_or_split(seg, take, out_segments)
            remaining -= take

        self._num_free -= n
        blocks = segments_to_blocks(out_segments)
        self._allocated.update(blocks)
        return blocks

    def _remove_or_split(self, seg: Segment, take: int, out: List[Segment]) -> None:
        # seg was already popped from the heaps; fix the address maps.
        del self._by_start[seg.start]
        del self._by_end[seg.end]
        taken, rest = seg.split(take)
        out.append(taken)
        if rest is not None:
            self._insert_free(rest)

    def extend(self, block_ids: Sequence[int], n: int) -> List[int]:
        """Grow an existing request, preferring blocks adjacent to its tail.

        Decode appends tokens one block at a time; extending in place keeps
        the request's run count low so later transfers stay cheap.
        """
        if n <= 0:
            raise ValueError("extension size must be positive")
        if n > self._num_free:
            raise OutOfBlocksError(f"requested {n} blocks, only {self._num_free} free")
        out: List[int] = []
        if block_ids:
            tail_end = int(block_ids[-1]) + 1
            adj = self._by_start.get(tail_end)
            if adj is not None:
                take = min(adj.length, n)
                self._heaps.discard(adj)
                segs: List[Segment] = []
                self._remove_or_split_from_maps(adj, take, segs)
                out.extend(segments_to_blocks(segs))
                self._num_free -= take
                self._allocated.update(out)
                n -= take
        if n > 0:
            out.extend(self.allocate(n))
        return out

    def _remove_or_split_from_maps(self, seg: Segment, take: int, out: List[Segment]) -> None:
        del self._by_start[seg.start]
        del self._by_end[seg.end]
        taken, rest = seg.split(take)
        out.append(taken)
        if rest is not None:
            self._insert_free(rest)

    def free(self, block_ids: Sequence[int]) -> None:
        """Free blocks, merging with adjacent free segments (paper §3.3)."""
        for b in block_ids:
            if b not in self._allocated:
                raise ValueError(f"double free of block {b}")
        for seg in blocks_to_segments(sorted(set(int(b) for b in block_ids))):
            self._allocated.difference_update(seg.blocks())
            merged = seg
            left = self._by_end.get(seg.start)
            if left is not None:
                self._remove_free(left)
                merged = merged.merge(left)
            right = self._by_start.get(seg.end)
            if right is not None:
                self._remove_free(right)
                merged = merged.merge(right)
            self._insert_free(merged)
            self._num_free += seg.length

    # -- introspection -------------------------------------------------------
    def free_segments(self) -> List[Segment]:
        return self._heaps.live_segments()

    def check_invariants(self) -> None:
        segs = self.free_segments()
        covered = sum(s.length for s in segs)
        assert covered == self._num_free, (covered, self._num_free)
        assert covered + len(self._allocated) == self.num_blocks
        for i in range(len(segs) - 1):
            a, b = segs[i], segs[i + 1]
            assert a.end < b.start, f"unmerged adjacent free segments {a}, {b}"
        for s in segs:
            assert not (set(s.blocks()) & self._allocated)


def make_allocator(kind: str, num_blocks: int):
    if kind in ("freelist", "vllm", "baseline"):
        return BlockAllocator(num_blocks)
    if kind in ("segment", "flowkv", "flowkv-segment"):
        return SegmentAllocator(num_blocks)
    raise ValueError(f"unknown allocator kind: {kind!r}")
