"""Run one cell of the benchmark on the card and print its result line.

    python3 flowbench/run.py --workload qwen3-1.7b.lb-qa --seed 7 --seconds 51 --trace 0

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number the correctness comparison
read beside its limit, which also end standard error. Exits non-zero and
prints no result when the card is missing, when the program cannot be
found in this checkout, or when JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _prepare() -> None:
    """Caches at fixed paths inside the checkout; the program from its src/;
    one CPU thread a pool (the host loop is one thread, and idle pool threads
    spinning beside it on a shared host make its speed vary run to run)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = ROOT / "build" / "flowbench" / "cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare()
    try:
        import repro_torch
    except ImportError as e:
        print(f"flowbench: the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"flowbench: repro_torch comes from {repro_torch.__file__}, not from "
              f"{ROOT / 'src'}", file=sys.stderr)
        return 2
    import torch
    from flowbench import harness

    torch.set_num_threads(1)

    try:
        res = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                              bench_root=ROOT, t_process=T_PROCESS)
    except harness.NoDevice as e:
        print(f"flowbench: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"flowbench: loaded {', '.join(bad)}: the port's run may not load JAX "
              "or the JAX package", file=sys.stderr)
        return 4
    for line in res.pop("log"):
        print(line, file=sys.stderr)
    checks = res.pop("checks")
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    for name, c in checks.items():
        lim = (f" limit {'>=' if c.get('at_least') else '<='} {c['limit']!r}"
               if "limit" in c else "")
        print(f"check {name} {c['value']!r}{lim}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
