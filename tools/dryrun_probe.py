#!/usr/bin/env python3
"""``chip_smoke.py``'s ``dryrun`` phase alone, the quickest check of the
dry-run accounting on the card: the env and build phases, then the
phase (three reduced qwen3-1.7b cells measured against their predictions,
every dry-run cell traced on the meta device, K4 at 32k).

    python3 tools/dryrun_probe.py        # on a machine with an H100 and nvcc

Prints what the phase prints, one JSON line a cell and part, and its wall
time; the cell records stay in ``results/dryrun_torch/``. Exits nonzero
where a gate of the phase fails.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("dryrun_probe: no GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    env = CS.phase_env(torch)
    CS.phase_build()
    CS.phase_dryrun(torch, env)
    CS.emit("dryrun_probe", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
