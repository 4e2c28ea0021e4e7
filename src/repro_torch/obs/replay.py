"""Deterministic trace replay through the cluster simulator.

A captured trace (``repro_torch.obs.tracing``) records the run's *inputs* — the
arrival process and each request's shape — separately from its *outputs*
(the spans). Replay rebuilds exactly those inputs and drives them through
:class:`repro_torch.sim.cluster_sim.ClusterSim` under any routing policy, so a
production capture becomes a repeatable scheduling experiment: "what would
this morning's traffic have done under round_robin?"

Determinism: the simulator is a pure discrete-event machine (heap ordered
by (time, seq), no wall clock, no RNG at run time), request ids and
arrivals come verbatim from the trace, and prompt tokens are either the
captured ones or regenerated by a fixed per-request hash — so the SAME
trace under the SAME policy yields an identical per-request stats dict
(``tests/test_obs.py`` asserts this).

CLI::

    PYTHONPATH=src python -m repro_torch.obs.replay trace.jsonl --policy load_aware
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Union

from repro_torch.configs import get_config
from repro_torch.obs.tracing import (SpanRecorder, Trace, attach_tracer,
                               read_trace, request_record, write_trace)
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.sim.cluster_sim import ROUTING_POLICIES, SYSTEMS, ClusterSim
from repro_torch.sim.hardware import get_hardware

# Capture meta keys build_sim() understands (anything else is carried along
# untouched — e.g. a capture timestamp or git sha stamped by the caller).
# "faults" is a FaultInjector.to_meta() dict: replaying a chaos capture
# rebuilds the same seeded injector, so the crashes/retries re-fire
# identically (the injector is reset at run start).
_SIM_META = ("system", "routing", "num_prefill", "num_decode", "same_host",
             "hardware", "config", "chunked_prefill", "prefill_chunk_tokens",
             "layer_window", "faults", "heartbeat_timeout")


def _synth_tokens(request_id: int, n: int, vocab: int = 32000) -> List[int]:
    """Deterministic stand-in prompt when the capture omitted tokens.

    A fixed affine hash per (request, position): stable across processes
    (unlike ``hash``), collision-free enough that two different requests
    never alias into a shared prefix by accident.
    """
    base = (request_id * 1_000_003) % vocab
    return [(base + i * 7_919 + 1) % vocab for i in range(n)]


def requests_from_trace(trace: Trace) -> List[Request]:
    """Rebuild the captured arrival process as fresh Request objects."""
    out = []
    for rec in trace.requests:
        tokens = rec.get("prompt_tokens")
        if tokens is None:
            tokens = _synth_tokens(rec["request_id"], rec["prompt_len"])
        out.append(Request(
            prompt_tokens=[int(t) for t in tokens],
            sampling=SamplingParams(max_new_tokens=int(rec["max_new_tokens"])),
            request_id=int(rec["request_id"]),
            arrival_time=float(rec["arrival_time"])))
    return out


def build_sim(meta: Dict[str, Any], policy: Optional[str] = None,
              **overrides) -> ClusterSim:
    """A ClusterSim matching a capture's meta, with ``policy``/kwargs on top."""
    kw = {k: meta[k] for k in _SIM_META if k in meta}
    kw.update(overrides)
    cfg = get_config(kw.pop("config", "llama31-8b"))
    kind = kw.pop("system", "flowkv")
    if kind not in SYSTEMS:
        raise ValueError(f"unknown system {kind!r} in trace meta")
    routing = policy or kw.pop("routing", None)
    kw.pop("routing", None)
    if routing is not None and routing not in ROUTING_POLICIES:
        raise ValueError(
            f"policy must be one of {ROUTING_POLICIES}, got {routing!r}")
    hw = kw.pop("hardware", None)
    if hw is not None:
        kw["hw_prefill"] = get_hardware(hw)
    return ClusterSim(cfg, kind, routing=routing, **kw)


def per_request_stats(requests: List[Request]) -> Dict[str, Dict[str, Any]]:
    """The determinism contract: one JSON-stable dict per request."""
    out = {}
    for r in sorted(requests, key=lambda r: r.request_id):
        row = {"state": r.state.value, "prompt_len": r.prompt_len,
               "new_tokens": r.num_output,
               "prefill_node": r.prefill_node, "decode_node": r.decode_node,
               "cached_prefix_tokens": r.num_cached_prefix_tokens}
        row.update(r.timing_breakdown())
        out[str(r.request_id)] = row
    return out


def replay(trace: Union[str, Trace], policy: Optional[str] = None,
           t_max: float = 50_000.0, **overrides) -> Dict[str, Any]:
    """Re-run a capture; returns aggregate stats + the per-request dict."""
    if not isinstance(trace, Trace):
        trace = read_trace(trace)
    if not trace.requests:
        raise ValueError("trace has no request records to replay "
                         "(captured without request shapes?)")
    sim = build_sim(trace.meta, policy=policy, **overrides)
    recorder = attach_tracer(sim)
    requests = requests_from_trace(trace)
    stats = sim.run(requests, t_max=t_max)
    return {
        "meta": dict(trace.meta),
        "policy": sim.routing,
        "stats": stats,
        "per_request": per_request_stats(requests),
        "num_spans": len(recorder.spans),
    }


def capture(sim: ClusterSim, requests: List[Request], path=None,
            t_max: float = 50_000.0, include_tokens: bool = False,
            meta: Optional[Dict[str, Any]] = None):
    """Run ``sim`` traced and (optionally) write the replayable capture.

    ``include_tokens=False`` records shapes only — enough for faithful
    latency replay; pass True when cross-request prefix sharing is the
    behavior under study. Returns ``(stats, recorder)``.
    """
    recorder = attach_tracer(sim)
    stats = sim.run(list(requests), t_max=t_max)
    if path is not None:
        recs = [request_record(
            r.request_id, r.arrival_time, r.prompt_len,
            r.sampling.max_new_tokens,
            prompt_tokens=r.prompt_tokens if include_tokens else None)
            for r in requests]
        full_meta = {"system": sim.kind, "routing": sim.routing,
                     "num_prefill": len([n for n in sim.nodes.values()
                                         if n.role == "prefill"]),
                     "num_decode": len([n for n in sim.nodes.values()
                                        if n.role == "decode"]),
                     "same_host": sim.same_host,
                     "heartbeat_timeout": sim.heartbeat_timeout,
                     **({"faults": sim.faults.to_meta()}
                        if sim.faults is not None else {}),
                     **(meta or {})}
        write_trace(path, recorder.spans, recs, meta=full_meta)
    return stats, recorder


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay a captured trace through ClusterSim")
    ap.add_argument("trace", help="trace JSONL written by repro_torch.obs.tracing")
    ap.add_argument("--policy", choices=ROUTING_POLICIES, default=None,
                    help="routing policy override (default: the capture's)")
    ap.add_argument("--t-max", type=float, default=50_000.0)
    ap.add_argument("--json", action="store_true",
                    help="print the full result (stats + per-request) as JSON")
    args = ap.parse_args(argv)
    result = replay(args.trace, policy=args.policy, t_max=args.t_max)
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        s = result["stats"]
        print(f"replayed {s['offered']} requests under {result['policy']}: "
              f"finished={s['finished']} rejected={s['rejected']} "
              f"p95_ttft_s={s['p95_ttft_s']:.3f} "
              f"throughput={s['throughput_tok_s']:.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
