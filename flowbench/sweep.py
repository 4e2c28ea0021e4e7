"""Find an open-loop cell's knee: run it at each rate in one process and
print, for each, the latencies and the backlog left when the window closed.

    python3 flowbench/sweep.py --workload qwen3-1.7b.lb-qa --seed 5 --seconds 30 \\
        --rates 1.5 2.0 2.5 3.0

The knee is the highest rate with no growing backlog (the requests still
waiting for their first token at the close stay few, and the later half's
TTFT does not climb above the earlier half's). Not used by the benchmark's
runs: a cell's rate is fixed in ``cells/<workload>.json``.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from flowbench import harness

    for rate in args.rates:
        res = harness.execute(args.workload, args.seed, args.seconds, False,
                              bench_root=ROOT, t_process=time.monotonic(),
                              load={"rate": rate})
        m = {k: v["value"] for k, v in res["metrics"].items()}
        print(json.dumps({"rate": rate, **m, **res["summary"], "correct": res["correct"],
                          "failed": res["failed"], "attempted": res["attempted"],
                          **{k: c["value"] for k, c in res["checks"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
