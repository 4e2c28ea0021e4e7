"""One traced run of a benchmark cell, then the engine's phases held against
the device trace: does the inside agree with the outside?

    python3 tools/phase_probe.py --workload qwen3-1.7b.lb-qa --seed 7 [--seconds 51] [--out DIR]

Runs ``flowbench/run.py --trace 1`` in this process (its result line and
log as usual) and keeps the run the metric readers saw. Then prints one
``phase_probe`` JSON line (also written to ``<out>/phase_probe_<seed>.json``,
``build/phase_probe/`` of the checkout unless ``--out`` names another folder):

* ``idle_by_phase``: the slice's idle seconds under each phase of the
  ``decode_step`` and ``prefill_chunk`` spans (``flowbench/phases.py``);
* ``decode_idle_inside`` / ``decode_idle_outside``: the idle under the five
  decode phases beside the idle the harness's wrap of ``run_decode``
  labels ``decode`` in the same run (``breakdown``), and the same for
  prefill;
* ``readback``: each stamped decode step of the slice and its argmax's
  device-to-host copy, matched by order (the first such copy after the
  step's K3 launches), and how far the copy lies outside the step's
  readback phase once the stamps are placed on the device's clock (the
  file also holds each step's readback phase and copy);
* ``k3_by_bucket``: K3's device time a step and its share of the roofline
  by the steps' padded lanes and block-table ``width``, over the real
  lanes' cached tokens and over all the lanes';
* ``records``: K3 launches beside layers x steps, the copies, and how far
  the first record starts after the slice's start and the last ends after
  its end (the harness synchronises before both stamps, so a last record
  past the end is the records' clock running apart from the host's);
* ``aligned``: whether the harness moved the slice onto the records' clock;
* ``pair_slope_ppm``: how far the two stamp pairs' slope (device clock over
  host clock) lies from 1, in parts per million;
* ``host_ms``: medians of each phase's host wall over the window's steps
  and chunks before the profiler;
* ``htod_per_span``: the median number of host-to-device copies a decode
  step and a prefill chunk of the slice make, whole and in the launch
  phase (each pageable copy waits for the stream to drain);
* ``transfer_split``: each ``transfer`` span of the slice (the P->D move
  and its verify, what ``transfer_p50_ms.qa`` reads) cut on the device's
  clock at its K1 runs: the wait from the span's start to K1's start, the
  device's busy time in that wait (work queued ahead of K1), K1's own
  device time, and the rest to the span's end (the verify and its
  read-back); medians in ms over the spans.
"""
import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from flowbench import devtrace, flops, harness, phases  # noqa: E402
from flowbench import run as bench_run  # noqa: E402


def _medians_ms(spans):
    by = {}
    for s in spans:
        for name, t0, t1 in phases.phases(s) or ():
            by.setdefault(name, []).append(t1 - t0)
    return {k: 1000.0 * statistics.median(v) for k, v in by.items()}


def _matched_steps(run):
    """Each stamped decode step of the slice with its own device records,
    matched by order, not by clock: the slice's K3 launches in runs of one
    a layer, and the first device-to-host copy after a step's run (the
    argmax's read-back: nothing else of the step copies to the host after
    its attention). None where the K3 launches are not one a layer a step."""
    steps = sorted((s for s in phases.slice_decode_steps(run) if phases.phases(s)),
                   key=lambda s: s.start_wall_s)
    n = run.cfg["num_hidden_layers"]
    k3 = sorted((s, e) for name, s, e in run.device_records if "paged_decode" in name)
    dtoh = sorted((s, e) for name, s, e in run.device_records if "DtoH" in name)
    if not steps or len(k3) != n * len(steps):
        return None
    out = []
    for i, st in enumerate(steps):
        run_ = k3[i * n:(i + 1) * n]
        out.append((st, run_, next((c for c in dtoh if c[0] >= run_[-1][1]), None)))
    return out


def _readback_placement(run, matched):
    """How far (ns) each step's argmax copy lies outside its readback phase
    once the stamps are mapped (0 inside), and a row a step: the phase and
    the copy, in microseconds from the slice's start."""
    lo = run.slice_ns[0]
    miss, rows = [], []
    for st, _, copy in matched or ():
        if copy is None:
            continue
        ph = {p: (a, b) for p, a, b in phases.phases(st)}
        r0, r1 = (phases.to_device_ns(run, t) for t in ph["readback"])
        miss.append(max(r0 - copy[0], copy[1] - r1, 0))
        rows.append([round((x - lo) / 1e3, 1) for x in (r0, r1, *copy)])
    return {"steps": len(miss), "outside": sum(m > 0 for m in miss),
            "largest_ns": max(miss, default=None), "rows_us": rows}


def _k3_by_bucket(run, matched):
    """K3's device time a step and its share of the roofline by the step's
    bucket, ``<lanes>x<width>`` (padded lanes by padded block-table width):
    over the real lanes' cached tokens (``k3_roofline.qa``'s count), and
    over the lanes' as if each pad lane held the real lanes' mean length
    (a pad lane repeats lane 0, whose length the span does not hold)."""
    by = {}
    for st, run_, _ in matched or ():
        a = st.attrs
        by.setdefault(f"{a['lanes']}x{a['width']}", []).append(
            (sum(e - s for s, e in run_) / 1e9, a["context_tokens"],
             a["context_tokens"] * a["lanes"] / a["batch"]))
    out = {}
    for key, rows in sorted(by.items(), key=lambda kv: [int(x) for x in kv[0].split("x")]):
        secs = sum(r[0] for r in rows)
        pct = [flops.roofline_pct(phases.k3_cost(run.cfg, sum(r[i] for r in rows)), secs,
                                  run.peak, run.cfg["dtype"]) for i in (1, 2)]
        out[key] = {"steps": len(rows), "k3_s": secs,
                    "k3_ms_p50": 1000.0 * statistics.median(r[0] for r in rows),
                    "context_tokens_p50": statistics.median(r[1] for r in rows),
                    "roofline_pct": pct[0], "roofline_pct_lanes": pct[1]}
    return out


def _copies_per_span(run, name, kind):
    """Median count of ``kind`` copies starting inside each stamped
    ``name`` span of the slice, whole and in its launch phase."""
    starts = sorted(s for n, s, _ in run.device_records if kind in n)
    lo, hi = run.slice_mono
    whole, launch = [], []
    for sp in run.spans:
        if sp.name != name or sp.start_wall_s is None or sp.end_wall_s is None \
                or sp.start_wall_s < lo or sp.end_wall_s > hi:
            continue
        ph = {p: (a, b) for p, a, b in phases.phases(sp) or ()}
        if "launch" not in ph:
            continue
        for out, (a, b) in ((whole, (sp.start_wall_s, sp.end_wall_s)), (launch, ph["launch"])):
            a, b = phases.to_device_ns(run, a), phases.to_device_ns(run, b)
            out.append(sum(1 for x in starts if a <= x <= b))
    return {"whole": statistics.median(whole) if whole else None,
            "launch": statistics.median(launch) if launch else None}


def _transfer_split(run):
    """Medians (ms) of each ``transfer`` span of the slice cut at its K1
    runs (device records named ``kv_transfer`` starting inside it)."""
    k1 = sorted((s, e) for n, s, e in run.device_records if "kv_transfer" in n)
    lo, hi = run.slice_mono
    rows = []
    for sp in run.spans:
        if sp.name != "transfer" or sp.start_wall_s is None or sp.end_wall_s is None \
                or sp.start_wall_s < lo or sp.end_wall_s > hi:
            continue
        a, b = phases.to_device_ns(run, sp.start_wall_s), phases.to_device_ns(run, sp.end_wall_s)
        mine = [r for r in k1 if a <= r[0] <= b]
        if not mine:
            continue
        first, last = mine[0][0], max(e for _, e in mine)
        rows.append({"span": b - a, "wait": first - a,
                     "wait_busy": devtrace.busy_ns(run.device_records, a, first),
                     "k1": sum(e - s for s, e in mine), "after": b - last})
    return {"spans": len(rows),
            **{k + "_ms_p50": statistics.median(r[k] for r in rows) / 1e6 if rows else None
               for k in ("span", "wait", "wait_busy", "k1", "after")}}


def analyse(run, moved):
    lo, hi = run.slice_ns
    inside = phases.idle_by_phase(run)
    outside = devtrace.idle_gaps(run.device_records, lo, hi, run.host)
    dec = sum(v for k, v in inside.items() if k.startswith("decode."))
    pre = sum(v for k, v in inside.items() if k.startswith("prefill."))
    matched = _matched_steps(run)
    steps_in = phases.slice_decode_steps(run)
    steps = phases.decode_steps(run)
    chunks = [s for s in run.spans if s.name == "prefill_chunk"
              and s.start_wall_s is not None and run.t_start <= s.start_wall_s
              and s.end_wall_s <= run.traced_from]
    return {
        "slice_s": (hi - lo) / 1e9, "aligned": moved,
        "pair_slope_ppm": 1e6 * ((hi - lo) / ((run.slice_mono[1] - run.slice_mono[0]) * 1e9)
                                 - 1.0),
        "idle_s": (hi - lo) / 1e9 - devtrace.busy_ns(run.device_records, lo, hi) / 1e9,
        "idle_by_phase": dict(sorted(inside.items())),
        "decode_idle_inside": dec, "decode_idle_outside": outside.get("decode", 0.0),
        "decode_agreement": dec / outside["decode"] - 1.0 if outside.get("decode") else None,
        "prefill_idle_inside": pre, "prefill_idle_outside": outside.get("prefill", 0.0),
        "readback": _readback_placement(run, matched),
        "k3_by_bucket": _k3_by_bucket(run, matched),
        "slice_decode_steps": len(steps_in),
        "records": {"k3": sum("paged_decode" in n for n, _, _ in run.device_records),
                    "k3_expected": run.cfg["num_hidden_layers"] * len(steps_in),
                    "dtoh": sum("DtoH" in n for n, _, _ in run.device_records),
                    "htod": sum("HtoD" in n for n, _, _ in run.device_records),
                    "first_after_start_ns": min(s for _, s, _ in run.device_records) - lo,
                    "last_after_end_ns": max(e for _, _, e in run.device_records) - hi},
        "host_ms": {"decode": _medians_ms(steps), "prefill": _medians_ms(chunks)},
        "htod_per_span": {"decode_step": _copies_per_span(run, "decode_step", "HtoD"),
                          "prefill_chunk": _copies_per_span(run, "prefill_chunk", "HtoD")},
        "transfer_split": _transfer_split(run),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", type=pathlib.Path, default=ROOT / "build" / "phase_probe")
    args = ap.parse_args()
    kept = {}
    align = harness._align

    def keep(run, log):
        before = run.slice_ns
        align(run, log)
        kept["run"], kept["moved"] = run, run.slice_ns != before

    harness._align = keep
    rc = bench_run.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "run" not in kept:
        return rc or 1
    res = analyse(kept["run"], kept["moved"])
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"phase_probe_{args.seed}.json").write_text(json.dumps(res, indent=1))
    res["readback"].pop("rows_us")
    print("phase_probe " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
