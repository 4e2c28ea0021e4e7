"""Read a cell's correctness numbers on many seeds in one process: for each
seed a run at the cell's own load and sizes (a shorter window), the widest
logit gap of the program's served tokens, and on the control's seeds the
control put in the program's place on the same sampled requests (the
reference with fp8 linear layers, the token it puts first), judged by the
same numbers and limits. PERF.md sets each limit between the two readings.

    python3 flowbench/calibrate.py --workload qwen3-1.7b.lb-qa --seconds 20 \\
        --seeds 11 12 13 --control 11 12 13

Not used by the benchmark's runs.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[],
                    help="the seeds on which the control is read too")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from flowbench import harness, run

    run._prepare()          # the benchmark's caches and threads
    torch.set_num_threads(1)

    for seed in args.seeds:
        t0 = time.monotonic()
        res = harness.execute(args.workload, seed, args.seconds, False, bench_root=ROOT,
                              t_process=t0, control=seed in args.control)
        out = {"seed": seed, "correct": res["correct"], "failed": res["failed"],
               "attempted": res["attempted"],
               **{k: c["value"] for k, c in res["checks"].items()},
               "run_s": time.monotonic() - t0}
        if "control" in res:
            out["control_correct"] = res["control"]["correct"]
            out.update({f"control_{k}": c["value"] for k, c in res["control"]["checks"].items()})
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
