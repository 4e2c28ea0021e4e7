"""Segment primitives for FlowKV's contiguity-aware KV-cache management.

A *segment* is a run of consecutive physical block ids ``[start, start+length)``.
FlowKV (paper §3.3) manages KV-cache memory at segment granularity so that a
request's blocks land in as few contiguous runs as possible, which in turn
lets the transfer engine move the whole run with a single kernel call.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class Segment:
    """A contiguous run of physical block ids ``[start, start + length)``."""

    start: int
    length: int

    def __post_init__(self) -> None:
        if self.length <= 0:
            raise ValueError(f"segment length must be positive, got {self.length}")
        if self.start < 0:
            raise ValueError(f"segment start must be >= 0, got {self.start}")

    @property
    def end(self) -> int:
        """Exclusive end block id."""
        return self.start + self.length

    def blocks(self) -> range:
        return range(self.start, self.end)

    def contains(self, block_id: int) -> bool:
        return self.start <= block_id < self.end

    def overlaps(self, other: "Segment") -> bool:
        return self.start < other.end and other.start < self.end

    def adjacent_to(self, other: "Segment") -> bool:
        return self.end == other.start or other.end == self.start

    def merge(self, other: "Segment") -> "Segment":
        if not (self.adjacent_to(other) or self.overlaps(other)):
            raise ValueError(f"cannot merge non-adjacent segments {self} and {other}")
        start = min(self.start, other.start)
        end = max(self.end, other.end)
        return Segment(start, end - start)

    def split(self, length: int) -> Tuple["Segment", "Segment | None"]:
        """Take the first ``length`` blocks; return (taken, remainder)."""
        if not 0 < length <= self.length:
            raise ValueError(f"cannot take {length} blocks from {self}")
        taken = Segment(self.start, length)
        if length == self.length:
            return taken, None
        return taken, Segment(self.start + length, self.length - length)


def blocks_to_segments(block_ids: Sequence[int]) -> List[Segment]:
    """Run-length encode an *ordered* block-id list into segments.

    Order is preserved: ``[5, 6, 7, 2, 3]`` -> ``[Segment(5,3), Segment(2,2)]``.
    This is exactly the representation FlowKV's bidirectional segment
    alignment operates on (paper Fig. 5).
    """
    segments: List[Segment] = []
    for block_id in block_ids:
        if segments and block_id == segments[-1].end:
            last = segments[-1]
            segments[-1] = Segment(last.start, last.length + 1)
        else:
            segments.append(Segment(int(block_id), 1))
    return segments


def segments_to_blocks(segments: Iterable[Segment]) -> List[int]:
    """Inverse of :func:`blocks_to_segments` (order preserving)."""
    out: List[int] = []
    for seg in segments:
        out.extend(seg.blocks())
    return out


def total_blocks(segments: Iterable[Segment]) -> int:
    return sum(seg.length for seg in segments)


def iter_pairs(segments: Sequence[Segment]) -> Iterator[Tuple[Segment, Segment]]:
    for i in range(len(segments) - 1):
        yield segments[i], segments[i + 1]


def validate_disjoint(segments: Sequence[Segment]) -> None:
    """Raise if any two segments overlap (allocator invariant)."""
    ordered = sorted(segments)
    for a, b in iter_pairs(ordered):
        if a.overlaps(b):
            raise ValueError(f"overlapping segments: {a} and {b}")


def fragmentation(segments: Sequence[Segment]) -> float:
    """1 - 1/num_runs for a request's block list; 0.0 = fully contiguous.

    Used by benchmarks to report how contiguous an allocator keeps requests.
    """
    if not segments:
        return 0.0
    return 1.0 - 1.0 / len(segments)
