#!/usr/bin/env python3
"""``chip_smoke.py``'s ``e2e_fleet`` phase alone, the quickest check of the
Load-Aware Scheduler on real engines on the card: the env and build
phases, then the phase (full-width qwen3-1.7b fp32 on one H100: the 1P+3D
flip run and its all-prefill local handoffs, the overload reject and
defer runs, decode preemption and cancel while swapped). With ``--train``
it also runs the train phase's ``train_main`` (its one load of the saved
train state).

    python3 tools/fleet_probe.py [--train]   # on a machine with an H100 and nvcc

Prints what the phases print and the wall time; exits nonzero where a gate
fails.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="also run train_main")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("fleet_probe: no GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    env = CS.phase_env(torch)
    CS.phase_build()
    t1 = time.perf_counter()
    CS.phase_e2e_fleet(torch, env)
    t2 = time.perf_counter()
    if args.train:
        CS._train_main(torch, env)
    CS.emit("fleet_probe", seconds=time.perf_counter() - t0, fleet_s=t2 - t1,
            train_main_s=time.perf_counter() - t2 if args.train else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
