"""Per-request span tracing for the disaggregated runtime.

A :class:`Span` is one phase of one request's life — ``queue``,
``admission``, ``prefill``, ``transfer``, ``decode`` or ``prefix_fetch`` —
stamped on BOTH timelines the system runs on:

* ``start_cycle`` / ``end_cycle`` — the driving scheduler clock. In the
  real runtime (``PDCluster``) this is the cluster cycle counter; in the
  discrete-event simulator (``ClusterSim``) it is simulated seconds.
* ``start_wall_s`` / ``end_wall_s`` — ``time.monotonic()`` stamps, so real
  runs report per-phase *seconds* without any cycle→s conversion. The
  simulator leaves these ``None`` (its virtual data plane consumes no wall
  time worth attributing).

The recorder is deliberately dumb — one list append per span, no locks, no
I/O on the hot path — so tracing can stay on during benchmarks. Export is
line-oriented JSON (one header record, then request-shape records, then
span records) so traces stream, diff and grep well; :func:`read_trace`
validates the schema version and round-trips exactly
(``tests/test_obs.py``).

Wiring: every producer (``PDCluster``, ``ClusterSim``, ``NodeEngine``,
``GlobalController``) reads an optional ``tracer`` attribute at emission
time, so :func:`attach_tracer` can instrument an already-constructed
cluster or simulator with no constructor plumbing.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

TRACE_SCHEMA_VERSION = 5

# Schema history: v1 had the six lifecycle span kinds; v2 (chunked prefill +
# layerwise overlap) added the fine-grained ``prefill_chunk`` and
# ``transfer_layer_window`` kinds; v3 (fault tolerance) added the
# ``failure`` / ``transfer_retry`` / ``recovery`` kinds; v4 (tiered KV)
# added ``tier_demote`` / ``tier_promote``; v5 (sharded serving) added the
# mesh-parallel transfer attrs (``src_tp`` / ``dst_tp`` / ``dispatches`` as
# shard-pair counts) on existing span kinds. Each bump is additive, so
# older traces still read.
SUPPORTED_SCHEMAS = (1, 2, 3, 4, 5)

# The span taxonomy (docs/observability.md). Producers are free to add new
# names — consumers must treat this as open — but these are the request
# lifecycle the replay/calibration tooling understands. ``prefill_chunk``
# and ``transfer_layer_window`` are sub-spans of ``prefill`` / ``transfer``:
# one per interleaved prompt chunk, one per layer-window sub-plan on the
# wire, so captured traces show the overlap instead of one opaque span.
# The fault kinds: ``failure`` marks a request drained off a dead node (or a
# transfer degraded to recompute), ``transfer_retry`` one failed/corrupt
# transfer attempt about to back off, ``recovery`` the failure-to-resumed
# interval (attrs carry replayed token counts).
# The tier kinds: ``tier_demote`` is one fused pool->host plan moving cold
# prefix blocks to DRAM under capacity pressure (trace_id -1: demotion is
# pressure-driven, not owned by any one request); ``tier_promote`` one fused
# host->pool plan bringing a prefix back for the request it serves.
# ``decode_step`` is one engine decode step over its whole batch (trace_id
# -1, as ``tier_demote``): its attrs count the batch's real lanes, padded
# lanes and cached tokens, and stamp its phases on ``wall()``; the
# ``prefill_chunk`` attrs ``t_upload`` / ``t_launch`` / ``t_write`` /
# ``t_readback`` stamp a chunk's phases the same way (serving/engine.py).
# Only real engines emit either's stamps; the simulator emits no
# ``decode_step``. New names and attrs need no schema bump: the taxonomy
# is open.
SPAN_NAMES = ("queue", "admission", "prefill", "prefill_chunk", "transfer",
              "transfer_layer_window", "decode", "prefix_fetch",
              "failure", "transfer_retry", "recovery",
              "tier_demote", "tier_promote", "decode_step")


@dataclasses.dataclass
class Span:
    """One phase of one request, on both clocks (None = not applicable)."""

    trace_id: int                        # request_id
    name: str                            # see SPAN_NAMES
    start_cycle: Optional[float] = None
    end_cycle: Optional[float] = None
    start_wall_s: Optional[float] = None
    end_wall_s: Optional[float] = None
    node_id: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def duration_cycles(self) -> Optional[float]:
        if self.start_cycle is None or self.end_cycle is None:
            return None
        return self.end_cycle - self.start_cycle

    def duration_wall_s(self) -> Optional[float]:
        if self.start_wall_s is None or self.end_wall_s is None:
            return None
        return self.end_wall_s - self.start_wall_s

    def to_record(self) -> Dict[str, Any]:
        rec = {"kind": "span", "trace_id": self.trace_id, "name": self.name}
        for key in ("start_cycle", "end_cycle", "start_wall_s", "end_wall_s",
                    "node_id"):
            val = getattr(self, key)
            if val is not None:
                rec[key] = val
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "Span":
        return cls(
            trace_id=int(rec["trace_id"]), name=rec["name"],
            start_cycle=rec.get("start_cycle"), end_cycle=rec.get("end_cycle"),
            start_wall_s=rec.get("start_wall_s"),
            end_wall_s=rec.get("end_wall_s"),
            node_id=rec.get("node_id"), attrs=dict(rec.get("attrs", {})))


class SpanRecorder:
    """Append-only span sink with a monotonic wall clock.

    ``wall()`` is the ONE wall-clock source every producer shares, so spans
    from different layers of the same process are comparable.
    """

    def __init__(self) -> None:
        self.spans: List[Span] = []

    def wall(self) -> float:
        return time.monotonic()

    def record(self, span: Span) -> None:
        self.spans.append(span)

    def emit(self, trace_id: int, name: str, **kw) -> Span:
        """Build-and-record in one call (the hot-path helper)."""
        span = Span(trace_id=trace_id, name=name, **kw)
        self.spans.append(span)
        return span

    # -- queries (post-run analysis; not hot-path) -----------------------------
    def for_trace(self, trace_id: int) -> List[Span]:
        return [s for s in self.spans if s.trace_id == trace_id]

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        self.spans.clear()


@dataclasses.dataclass
class Trace:
    """A captured run: metadata + request shapes + spans.

    ``requests`` records are what :mod:`repro_torch.obs.replay` rebuilds the
    arrival process from; ``spans`` are the measured phases of the run that
    produced the capture.
    """

    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    requests: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    spans: List[Span] = dataclasses.field(default_factory=list)

    @property
    def schema(self) -> int:
        return int(self.meta.get("schema", TRACE_SCHEMA_VERSION))


def request_record(request_id: int, arrival_time: float, prompt_len: int,
                   max_new_tokens: int,
                   prompt_tokens: Optional[Sequence[int]] = None
                   ) -> Dict[str, Any]:
    """The replayable shape of one request.

    ``prompt_tokens`` is optional: without it the replay harness regenerates
    token ids deterministically from the request id (identical shapes and
    arrivals, but cross-request prefix sharing is not preserved — capture
    with tokens when prefix-reuse behavior is what you are replaying).
    """
    rec = {"kind": "request", "request_id": int(request_id),
           "arrival_time": float(arrival_time), "prompt_len": int(prompt_len),
           "max_new_tokens": int(max_new_tokens)}
    if prompt_tokens is not None:
        rec["prompt_tokens"] = [int(t) for t in prompt_tokens]
    return rec


def write_trace(path: Union[str, pathlib.Path], spans: Iterable[Span],
                requests: Iterable[Dict[str, Any]] = (),
                meta: Optional[Dict[str, Any]] = None) -> pathlib.Path:
    """Write a trace as JSONL: header, then requests, then spans."""
    path = pathlib.Path(path)
    header = {"kind": "header", "schema": TRACE_SCHEMA_VERSION,
              **(meta or {})}
    with path.open("w") as f:
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for rec in requests:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        for span in spans:
            f.write(json.dumps(span.to_record(), sort_keys=True) + "\n")
    return path


def read_trace(path: Union[str, pathlib.Path]) -> Trace:
    """Parse + schema-validate a trace written by :func:`write_trace`."""
    trace = Trace()
    with pathlib.Path(path).open() as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if i == 0:
                if kind != "header":
                    raise ValueError(
                        f"{path}: first record must be the trace header, "
                        f"got kind={kind!r}")
                schema = int(rec.get("schema", -1))
                if schema not in SUPPORTED_SCHEMAS:
                    raise ValueError(
                        f"{path}: trace schema {schema} not in supported "
                        f"{SUPPORTED_SCHEMAS}")
                trace.meta = {k: v for k, v in rec.items() if k != "kind"}
            elif kind == "request":
                trace.requests.append(rec)
            elif kind == "span":
                trace.spans.append(Span.from_record(rec))
            else:
                raise ValueError(f"{path}: unknown record kind {kind!r} "
                                 f"on line {i + 1}")
    if not trace.meta:
        raise ValueError(f"{path}: empty trace (no header)")
    return trace


def attach_tracer(target, recorder: Optional[SpanRecorder] = None
                  ) -> SpanRecorder:
    """Instrument a live ``PDCluster`` or ``ClusterSim`` (and its controller
    and engines) with a span recorder; returns the recorder.

    Producers read ``self.tracer`` at emission time, so attaching after
    construction instruments everything from the next event on.
    """
    recorder = recorder or SpanRecorder()
    target.tracer = recorder
    controller = getattr(target, "controller", None)
    if controller is not None:
        controller.tracer = recorder
    for engine in getattr(target, "engines", {}).values():
        engine.tracer = recorder
    return recorder
