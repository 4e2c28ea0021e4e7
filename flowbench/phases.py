"""The engine's phase spans on the device trace's clock.

The program's ``decode_step`` spans and its ``prefill_chunk`` spans carry
phase stamps on the host's monotonic clock (``serving/engine.py``):

* a decode step: prep (block tables and padding) | ``t_upload`` | upload
  (the three host->card copies) | ``t_launch`` | launch (the forward's
  enqueue) | ``t_readback`` | readback (the argmax's copy to the host) |
  ``t_post`` | post (tokens appended, finished checks, the scheduler);
* a prefill chunk: prep (the prefix gather of a suffix chunk) |
  ``t_upload`` | upload (the chunk's tokens) | ``t_launch`` | launch (the
  forward) | ``t_write`` | write (the pool write) | ``t_readback`` on the
  final chunk | readback (the argmax).

A stamp moves onto the profiler's clock linearly between the two pairs of
stamps the harness takes back to back, at the slice's start and at its end:
``t_dev_ns = slice_ns[0] + (t_mono - slice_mono[0]) * (slice_ns[1] -
slice_ns[0]) / (slice_mono[1] - slice_mono[0])`` (``slice_ns`` as
``_align`` left it). A program without the stamps (or without
``decode_step`` spans) gives these readers nothing: they return None.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from flowbench import devtrace, flops, readers, stats

DECODE_STAMPS = (("prep", "t_upload"), ("upload", "t_launch"), ("launch", "t_readback"),
                 ("readback", "t_post"))
PREFILL_STAMPS = (("prep", "t_upload"), ("upload", "t_launch"), ("launch", "t_write"),
                  ("write", "t_readback"))
PHASES = {"decode_step": ("decode", DECODE_STAMPS, "post"),
          "prefill_chunk": ("prefill", PREFILL_STAMPS, "readback")}


def to_device_ns(run, t_mono: float) -> int:
    """A host monotonic stamp on the device records' clock."""
    (m0, m1), (n0, n1) = run.slice_mono, run.slice_ns
    return n0 + round((t_mono - m0) * (n1 - n0) / (m1 - m0))


def phases(span) -> Optional[List[Tuple[str, float, float]]]:
    """``(phase, start, end)`` on the host's clock, in order, of a stamped
    ``decode_step`` or ``prefill_chunk`` span; None for an unstamped one. A
    prefill chunk that is not the last has no readback phase."""
    _, stamps, last = PHASES[span.name]
    a = span.attrs
    if span.start_wall_s is None or span.end_wall_s is None or stamps[0][1] not in a:
        return None
    out, t = [], span.start_wall_s
    for phase, key in stamps:
        if key not in a:                     # the final stamp of a chunk that is not final
            out.append((phase, t, span.end_wall_s))
            return out
        out.append((phase, t, a[key]))
        t = a[key]
    out.append((last, t, span.end_wall_s))
    return out


def host_intervals(run, phase: Optional[str] = None) -> List[Tuple[str, int, int]]:
    """``("decode.launch", start_ns, end_ns)``, ... on the device's clock:
    each phase (or only ``phase``) of every stamped span that overlaps the
    traced slice. Spans run on one host thread, so these do not overlap."""
    if run.slice_mono is None or run.slice_ns is None:
        return []
    lo, hi = run.slice_mono
    out = []
    for s in run.spans:
        if s.name not in PHASES or s.end_wall_s is None or s.start_wall_s is None \
                or s.end_wall_s < lo or s.start_wall_s > hi:
            continue
        for name, t0, t1 in phases(s) or ():
            if phase is None or name == phase:
                out.append((f"{PHASES[s.name][0]}.{name}", to_device_ns(run, t0),
                            to_device_ns(run, t1)))
    return sorted(out, key=lambda x: x[1])


def idle_by_phase(run, phase: Optional[str] = None) -> Dict[str, float]:
    """Idle seconds of the traced slice by the engine phase the host was in
    (``"decode.upload"``, ...); idle outside every phase is left out."""
    if not run.device_records or run.slice_ns is None:
        return {}
    lo, hi = run.slice_ns
    gaps = devtrace.idle_gaps(run.device_records, lo, hi, host_intervals(run, phase))
    gaps.pop("harness", None)
    return gaps


def decode_steps(run) -> List:
    """The window's ``decode_step`` spans that ended before the profiler
    started (as ``readers.span_walls`` takes the request spans)."""
    return [s for s in run.spans if s.name == "decode_step" and s.start_wall_s is not None
            and s.end_wall_s is not None and s.start_wall_s >= run.t_start
            and s.end_wall_s <= run.traced_from]


def slice_decode_steps(run) -> List:
    """The ``decode_step`` spans wholly inside the traced slice (the rule
    of ``Run.slice_steps``)."""
    if run.slice_mono is None:
        return []
    lo, hi = run.slice_mono
    return [s for s in run.spans if s.name == "decode_step" and s.start_wall_s is not None
            and s.end_wall_s is not None and s.start_wall_s >= lo and s.end_wall_s <= hi]


def step_wall_p50_ms(run) -> Optional[float]:
    walls = [s.duration_wall_s() for s in decode_steps(run)]
    return 1000.0 * stats.percentile(walls, 50) if walls else None


def step_host_p50_ms(run) -> Optional[float]:
    """Median of each stamped step's wall less its upload and readback
    phases: the host's own time a step (prep, launch and post)."""
    own = []
    for s in decode_steps(run):
        ph = phases(s)
        if ph is not None:
            own.append(sum(t1 - t0 for name, t0, t1 in ph if name in ("prep", "launch", "post")))
    return 1000.0 * stats.percentile(own, 50) if own else None


def pad_pct(run) -> Optional[float]:
    steps = decode_steps(run)
    lanes = sum(s.attrs["lanes"] for s in steps)
    if lanes == 0:
        return None
    return 100.0 * (lanes - sum(s.attrs["batch"] for s in steps)) / lanes


def launch_idle_pct(run) -> Optional[float]:
    """Share of the traced slice in which the card ran nothing while the
    host was in the launch phase of a decode step or a prefill chunk."""
    secs = readers.slice_seconds(run)
    if secs is None or not host_intervals(run, "launch"):
        return None
    return 100.0 * sum(idle_by_phase(run, "launch").values()) / secs


def k3_cost(cfg, context_tokens: float) -> Dict[str, float]:
    """K3's work over ``context_tokens`` cached tokens, every layer: their
    K/V bytes and their attention FLOPs."""
    return {"flops": flops.attn_pair_flops(cfg) * context_tokens,
            "bytes": float(context_tokens * flops.kv_bytes_per_token(cfg))}


def k3_roofline(run) -> Optional[float]:
    """K3's least time for the slice's decode steps (the real lanes' cached
    tokens: their K/V bytes at HBM bandwidth, or their attention FLOPs at
    the peak, the larger) over K3's device time, in %."""
    secs = readers.kernel_seconds(run, "paged_decode")
    ctx = sum(s.attrs["context_tokens"] for s in slice_decode_steps(run))
    if secs <= 0 or run.peak is None or ctx == 0:
        return None
    return flops.roofline_pct(k3_cost(run.cfg, ctx), secs, run.peak, run.cfg["dtype"])
