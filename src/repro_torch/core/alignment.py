"""Bidirectional segment alignment (paper §3.3, Fig. 5).

Before a KV transfer, the sender and receiver exchange their block-id lists
for the request. The lists have identical length ``n`` (same tokens, same
block size) but independent physical placement. A *single* transfer call can
cover positions ``[i, i+m)`` iff the corresponding block ids are consecutive
on the sender **and** on the receiver — then both sides see one contiguous
memory range.

``align`` computes the maximal such runs in O(n): position ``j`` extends the
current run iff ``src[j] == src[j-1] + 1 and dst[j] == dst[j-1] + 1``.

The ideal case in the paper (both allocators segment-aware, low churn) yields
one run — O(n) calls become O(1).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.segments import Segment


@dataclasses.dataclass(frozen=True)
class AlignedRun:
    """A transferable run: src/dst segments of equal length."""

    src: Segment
    dst: Segment

    def __post_init__(self) -> None:
        if self.src.length != self.dst.length:
            raise ValueError(f"mismatched run lengths: {self.src} vs {self.dst}")

    @property
    def length(self) -> int:
        return self.src.length


@dataclasses.dataclass(frozen=True)
class AlignmentResult:
    runs: List[AlignedRun]
    num_blocks: int

    @property
    def num_calls(self) -> int:
        return len(self.runs)

    @property
    def merge_ratio(self) -> float:
        """blocks per call; num_blocks == num_calls means nothing merged."""
        return self.num_blocks / max(1, self.num_calls)


def align(src_blocks: Sequence[int], dst_blocks: Sequence[int]) -> AlignmentResult:
    """Bidirectional segment alignment of two equal-length block-id lists."""
    if len(src_blocks) != len(dst_blocks):
        raise ValueError(
            f"src and dst block lists must have equal length, got "
            f"{len(src_blocks)} vs {len(dst_blocks)}"
        )
    n = len(src_blocks)
    runs: List[AlignedRun] = []
    if n == 0:
        return AlignmentResult(runs=runs, num_blocks=0)

    run_start = 0
    for j in range(1, n + 1):
        extends = (
            j < n
            and src_blocks[j] == src_blocks[j - 1] + 1
            and dst_blocks[j] == dst_blocks[j - 1] + 1
        )
        if not extends:
            length = j - run_start
            runs.append(
                AlignedRun(
                    src=Segment(int(src_blocks[run_start]), length),
                    dst=Segment(int(dst_blocks[run_start]), length),
                )
            )
            run_start = j
    return AlignmentResult(runs=runs, num_blocks=n)


def reconstruct(result: AlignmentResult) -> tuple[List[int], List[int]]:
    """Inverse of :func:`align` — used by property tests."""
    src: List[int] = []
    dst: List[int] = []
    for run in result.runs:
        src.extend(run.src.blocks())
        dst.extend(run.dst.blocks())
    return src, dst
