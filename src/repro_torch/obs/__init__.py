"""Observability plane (port of ``repro/obs``).

* ``tracing``   — low-overhead per-request span recorder (queue / admission /
                  prefill / transfer / decode / prefix_fetch) with both
                  scheduler-clock and wall-clock timestamps, JSONL export,
                  and ``attach_tracer`` to wire a recorder into a live
                  ``PDCluster`` or ``ClusterSim``.
* ``calibrate`` — fits ``TransportProfile`` / ``HardwareProfile``
                  coefficients from measured timings; its sweep times the
                  port's own prefill, on the GPU by default.
* ``replay``    — deterministically re-runs a captured trace's arrival
                  process and request shapes through ``ClusterSim`` under
                  any routing policy; a trace either package writes replays
                  in the other.
* ``history``   — schema-versioned ``BENCH_<area>.json`` records. Nothing in
                  the port records one; callers pass an explicit ``root``.
"""
from repro_torch.obs.tracing import (Span, SpanRecorder, Trace, attach_tracer,
                                     read_trace, write_trace)

__all__ = ["Span", "SpanRecorder", "Trace", "attach_tracer", "read_trace",
           "write_trace"]
