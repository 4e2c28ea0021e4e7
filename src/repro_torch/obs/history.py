"""Cross-PR performance trajectory: append-only BENCH_<area>.json files.

Every gated benchmark (``--json``/``--check`` CLI contract) can also append
its headline metrics to a schema-versioned history file at the repo root —
``BENCH_transfer.json``, ``BENCH_decode.json``, ``BENCH_scenarios.json``,
``BENCH_prefix.json``, ``BENCH_breakdown.json``, ``BENCH_chunked.json``,
``BENCH_tiered.json``, ``BENCH_sharded.json``, ``BENCH_faults.json`` — via
its ``--history``
flag. The files are committed, so the repo carries its own perf trajectory:
each PR's CI run appends one entry, and ``tools/bench_history.py --check``
fails the build when the newest entry regresses against the committed
baseline.

File shape::

    {"schema": 1, "area": "transfer",
     "baseline": {metric: value, ...},          # the gate
     "entries": [{"ts": ..., "metrics": {...}}, ...]}   # the trajectory

Per-metric gating modes (:data:`AREAS`):

* ``exact`` — structural counters (dispatch counts, call counts): any
  drift is a data-plane change and must be acknowledged by editing the
  committed baseline in the same PR.
* ``le`` / ``ge`` — bounded metrics (latency fractions must not grow,
  goodput must not shrink) with a small relative tolerance; deterministic
  sim outputs get a tight one, analytics get zero.
* ``info`` — wall-clock measurements: recorded for the trajectory, never
  gated (shared CI hosts are not a benchmark machine).

The first ``record()`` for an area creates the file with the entry as
baseline; re-baselining after an intentional change = delete the file (or
edit ``baseline``) and re-record.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any, Dict, List, Optional, Union

SCHEMA_VERSION = 1

# Repo root: src/repro_torch/obs/history.py -> three parents up.
ROOT = pathlib.Path(__file__).resolve().parents[3]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    mode: str            # "exact" | "le" | "ge" | "info"
    tol: float = 0.0     # relative tolerance for le/ge


# The gated surface per area. Metrics a benchmark emits beyond these are
# recorded in the trajectory but not checked (open schema, like spans).
AREAS: Dict[str, Dict[str, MetricSpec]] = {
    "transfer": {
        # planner/executor structure: exact by construction
        "flowkv_calls": MetricSpec("exact"),
        "blockwise_calls": MetricSpec("exact"),
        "layerwise_calls": MetricSpec("exact"),
        "flowkv_dispatches": MetricSpec("exact"),
        "blockwise_dispatches": MetricSpec("exact"),
        "layerwise_dispatches": MetricSpec("exact"),
        "flowkv_wall_s": MetricSpec("info"),
    },
    "decode": {
        "kernel_max_dispatches_per_step": MetricSpec("exact"),
        "dense_max_dispatches_per_step": MetricSpec("exact"),
        "kernel_compile_variants": MetricSpec("le"),   # buckets may shrink
        "kernel_min_tokens_per_s": MetricSpec("info"),
    },
    "scenarios": {
        # deterministic discrete-event sim: tight but not bit-exact bounds
        # (float accumulation order may shift across numpy/jax versions)
        "imbalance_load_aware_goodput": MetricSpec("ge", 0.02),
        "imbalance_load_aware_p95_ttft_s": MetricSpec("le", 0.05),
        "overload_load_aware_goodput": MetricSpec("ge", 0.02),
        "overload_load_aware_p95_ttft_s": MetricSpec("le", 0.05),
        "overload_rejected": MetricSpec("info"),
        "normal_load_aware_goodput": MetricSpec("ge", 0.0),
        "heterogeneous_load_aware_goodput": MetricSpec("ge", 0.02),
        "heterogeneous_starved_nodes": MetricSpec("exact"),
    },
    "chunked": {
        # long-prompt-mix A/B on the deterministic sim (benchmarks/
        # chunked_prefill.py): chunked+overlap must keep beating lockstep
        # on p95 TTFT, and layer-window streaming must keep hiding a
        # meaningful share of transfer wall time.
        "lockstep_p95_ttft_s": MetricSpec("info"),
        "chunked_p95_ttft_s": MetricSpec("le", 0.05),
        "overlap_p95_ttft_s": MetricSpec("le", 0.05),
        "overlap_p95_speedup": MetricSpec("ge", 0.02),
        "overlap_hidden_frac": MetricSpec("ge", 0.02),
        "overlap_windows_per_transfer": MetricSpec("exact"),
    },
    "prefix": {
        "engine_tokens_saved_total": MetricSpec("ge", 0.0),
        "engine_max_fetch_dispatches": MetricSpec("exact"),
        "sim_tokens_saved_share1": MetricSpec("ge", 0.0),
        "sim_mean_fetch_dispatches_share1": MetricSpec("exact"),
    },
    "breakdown": {
        # analytic single-request split: zero-tolerance bounds
        "flowkv_xfer_frac": MetricSpec("le", 0.0),
        "blockwise_xfer_frac": MetricSpec("info"),
        "flowkv_over_blockwise_xfer": MetricSpec("le", 0.0),
    },
    "tiered": {
        # multiturn-scenario A/B (benchmarks/tiered_kv.py): the host-DRAM
        # tier must keep beating the HBM-only pool on p95 TTFT and prefix
        # hit rate, with structurally zero leaked blocks on either tier.
        "p95_ttft_speedup": MetricSpec("ge", 0.02),
        "tiered_hit_rate": MetricSpec("ge", 0.02),
        "hbm_hit_rate": MetricSpec("info"),
        "tiered_p95_ttft_s": MetricSpec("le", 0.05),
        "leaked_blocks": MetricSpec("exact"),
        "demoted_blocks": MetricSpec("info"),
        "promoted_blocks": MetricSpec("info"),
        "engine_promoted_blocks": MetricSpec("exact"),
        "engine_wall_s": MetricSpec("info"),
    },
    "sharded": {
        # mesh-parallel serving (benchmarks/sharded_transfer.py): shard-pair
        # dispatch counts are structural (tp_src + tp_dst - gcd per plan),
        # token identity vs the single-device engine and byte conservation
        # across cross-degree transfers are exact-by-construction zeros.
        "dispatches_tp2_to_tp1": MetricSpec("exact"),
        "dispatches_tp1_to_tp2": MetricSpec("exact"),
        "dispatches_tp2_to_tp2": MetricSpec("exact"),
        "token_mismatches": MetricSpec("exact"),
        "transfer_byte_mismatches": MetricSpec("exact"),
        "sim_mean_transfer_dispatches": MetricSpec("exact"),
        "sharded_decode_wall_s": MetricSpec("info"),
    },
    "faults": {
        # chaos A/B (benchmarks/fault_tolerance.py): the failure scenario
        # vs its fault-free twin. Goodput under faults must stay a bounded
        # fraction of fault-free; divergence/leak counters are structural
        # zeros — any drift is a recovery-correctness bug, not noise.
        "goodput_ratio": MetricSpec("ge", 0.05),
        "token_divergence": MetricSpec("exact"),
        "leaked_blocks": MetricSpec("exact"),
        "unfinished": MetricSpec("exact"),
        "fault_kills": MetricSpec("exact"),
        "recoveries": MetricSpec("info"),
        "transfer_retries": MetricSpec("info"),
        "degraded_to_recompute": MetricSpec("info"),
    },
}


def bench_path(area: str, root: Optional[Union[str, pathlib.Path]] = None
               ) -> pathlib.Path:
    return pathlib.Path(root or ROOT) / f"BENCH_{area}.json"


def load(area: str, root=None) -> Optional[Dict[str, Any]]:
    path = bench_path(area, root)
    if not path.exists():
        return None
    data = json.loads(path.read_text())
    schema = int(data.get("schema", -1))
    if schema != SCHEMA_VERSION:
        raise ValueError(f"{path}: history schema {schema} != supported "
                         f"{SCHEMA_VERSION}")
    return data


def record(area: str, metrics: Dict[str, float], root=None,
           ts: Optional[str] = None) -> Dict[str, Any]:
    """Append one trajectory entry; first entry becomes the baseline."""
    if area not in AREAS:
        raise ValueError(f"unknown area {area!r}; have {sorted(AREAS)}")
    metrics = {k: float(v) for k, v in metrics.items()}
    data = load(area, root)
    if data is None:
        data = {"schema": SCHEMA_VERSION, "area": area,
                "baseline": dict(metrics), "entries": []}
    data["entries"].append({
        "ts": ts or time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "metrics": metrics,
    })
    path = bench_path(area, root)
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return data


def check_metrics(area: str, baseline: Dict[str, float],
                  metrics: Dict[str, float]) -> List[str]:
    """Compare one metrics dict against a baseline; returns failures."""
    failures = []
    for name, spec in AREAS[area].items():
        if name not in baseline:
            continue      # baseline predates the metric: nothing to gate on
        if name not in metrics:
            failures.append(f"{area}/{name}: missing from latest entry "
                            f"(baseline has {baseline[name]})")
            continue
        base, val = baseline[name], metrics[name]
        if spec.mode == "exact":
            if abs(val - base) > _EPS:
                failures.append(f"{area}/{name}: {val} != baseline {base} "
                                f"(exact metric — edit the baseline if the "
                                f"change is intentional)")
        elif spec.mode == "le":
            limit = base * (1.0 + spec.tol) + _EPS
            if val > limit:
                failures.append(f"{area}/{name}: {val} > baseline {base} "
                                f"(+{spec.tol:.0%} tolerance)")
        elif spec.mode == "ge":
            limit = base * (1.0 - spec.tol) - _EPS
            if val < limit:
                failures.append(f"{area}/{name}: {val} < baseline {base} "
                                f"(-{spec.tol:.0%} tolerance)")
        # "info": trajectory only
    return failures


def check(area: str, root=None) -> List[str]:
    """Gate an area's NEWEST entry against its committed baseline."""
    data = load(area, root)
    if data is None:
        return []        # no history for this area yet: nothing to gate
    if not data["entries"]:
        return [f"{area}: history file has a baseline but no entries"]
    return check_metrics(area, data["baseline"],
                         data["entries"][-1]["metrics"])


def check_all(areas: Optional[List[str]] = None, root=None
              ) -> Dict[str, List[str]]:
    """{area: failures} over the requested (default: all known) areas."""
    return {a: check(a, root) for a in (areas or sorted(AREAS))}
