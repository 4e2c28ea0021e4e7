"""Device activity from torch.profiler's raw records: the busy union, the
time of each kernel by name, and the idle gaps labelled by what the host
was doing. It reads ``prof.profiler.kineto_results.events()``, never
``key_averages()``, which takes minutes over a serving window's kernels."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]


def device_records(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every operation the profiler saw on a
    CUDA device: kernels, copies and memsets."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.end_ns()))
    return out


def union(intervals: Sequence[Interval]) -> List[Interval]:
    merged: List[Interval] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


def busy_ns(records, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] in which some device operation ran."""
    clipped = [(max(s, lo), min(e, hi)) for _, s, e in records if e > lo and s < hi]
    return sum(e - s for s, e in union(clipped))


def by_name(records, contains: str = "") -> Dict[str, float]:
    """Seconds of device time by operation name (names holding ``contains``)."""
    out: Dict[str, float] = {}
    for name, s, e in records:
        if contains in name:
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def idle_gaps(records, lo: int, hi: int, host: Sequence[Tuple[str, int, int]]
              ) -> Dict[str, float]:
    """Idle seconds of [lo, hi] summed by what the host was doing: each gap
    between device operations is split over the host intervals ``(label,
    start_ns, end_ns)`` that cover it; uncovered time is ``harness``."""
    busy = union([(max(s, lo), min(e, hi)) for _, s, e in records if e > lo and s < hi])
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    host = sorted(host, key=lambda x: x[1])
    out: Dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(host) and host[j][2] <= g0:
            j += 1
        k = j
        while k < len(host) and host[k][1] < g1:
            label, h0, h1 = host[k]
            ov = min(h1, g1) - max(h0, g0)
            if ov > 0:
                out[label] = out.get(label, 0.0) + ov / 1e9
                covered += ov
            k += 1
        rest = (g1 - g0) - covered
        if rest > 0:
            out["harness"] = out.get("harness", 0.0) + rest / 1e9
    return out
