"""What the metric readers share: the window's latencies, spans by name,
the traced slice's work and device time. A reader returns None where its
cell gives it nothing to read."""
from __future__ import annotations

from typing import List, Optional

from flowbench import devtrace, flops, stats


def ttfts(run) -> List[float]:
    """Time to first token of every request sent in the window, from when
    it was due."""
    return [r.first_t - r.due_at for r in run.window_reqs() if r.first_t is not None]


def itl_gaps(run) -> List[float]:
    """Every gap between consecutive tokens of a request whose later token
    came inside the window."""
    out = []
    for r in run.reqs:
        t = r.token_t
        out.extend(b - a for a, b in zip(t, t[1:]) if run.t_start < b <= run.t_end)
    return out


def span_walls(run, name: str) -> List[float]:
    """Walls of the program's ``name`` spans of requests sent in the window
    that ended before the profiler started."""
    ids = run.window_trace_ids()
    return [s.duration_wall_s() for s in run.spans
            if s.name == name and s.trace_id in ids and s.end_wall_s is not None
            and s.start_wall_s is not None and s.end_wall_s <= run.traced_from]


def pct(values, p) -> Optional[float]:
    return stats.percentile(values, p) if values else None


def slice_chunks(run) -> List[dict]:
    """The prefill chunks the traced slice ran (their offsets and lengths)."""
    if run.slice_mono is None:
        return []
    lo, hi = run.slice_mono
    return [s.attrs for s in run.spans if s.name == "prefill_chunk"
            and s.start_wall_s is not None and lo <= s.start_wall_s <= hi]


def slice_seconds(run) -> Optional[float]:
    if run.slice_ns is None or not run.device_records:
        return None
    return (run.slice_ns[1] - run.slice_ns[0]) / 1e9


def mfu(run) -> Optional[float]:
    """The slice's work in FLOPs over (slice x the bf16 peak), in %."""
    secs = slice_seconds(run)
    if secs is None or run.peak is None:
        return None
    cfg = run.cfg
    work = sum(flops.chunk_flops(cfg, c["offset"], c["tokens"], c["final"])
               for c in slice_chunks(run))
    work += sum(flops.decode_flops(cfg, c) for s in run.slice_steps()
                for c in s.decode_contexts)
    if work == 0:
        return None
    return 100.0 * work / (secs * run.peak[flops.PEAK_KEY[cfg["dtype"]]])


def kernel_seconds(run, fragment: str) -> float:
    return sum(devtrace.by_name(run.device_records, fragment).values())


def idle_pct(run) -> Optional[float]:
    secs = slice_seconds(run)
    if secs is None:
        return None
    lo, hi = run.slice_ns
    return 100.0 * (1.0 - devtrace.busy_ns(run.device_records, lo, hi) / (hi - lo))
