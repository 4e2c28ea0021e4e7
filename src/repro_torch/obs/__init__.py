"""Observability plane (port of ``repro/obs``).

* ``tracing`` — low-overhead per-request span recorder (queue / admission /
  prefill / transfer / decode / prefix_fetch) with both scheduler-clock and
  wall-clock timestamps, JSONL export, and ``attach_tracer`` to wire a
  recorder into a live ``PDCluster``.

Only ``tracing`` is ported so far; ``calibrate``, ``replay`` and ``history``
come with ROADMAP.md item 10.
"""
from repro_torch.obs.tracing import (Span, SpanRecorder, Trace, attach_tracer,
                                     read_trace, write_trace)

__all__ = ["Span", "SpanRecorder", "Trace", "attach_tracer", "read_trace",
           "write_trace"]
