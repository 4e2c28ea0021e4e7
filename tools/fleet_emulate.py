#!/usr/bin/env python3
"""Predict ``chip_smoke.py``'s ``e2e_fleet`` control decisions on the CPU.

Runs the phase on the CPU at the qwen3-1.7b smoke config's widths (2
layers, d 64) with the full qwen3-1.7b cost model in every controller
(``ModelCost`` from the full config), so routing, admission, flips,
preemption and every cycle stamp are those the card run makes: the
controller reads only token and block counts and that cost model. Walls
are the CPU's and mean nothing for the card; the wrappers count launches
on CUDA tensors only, so the gates that read launch counts cannot hold
here and are listed on stderr instead of failing the run. Prints the
phase's JSON line.

    PYTHONPATH=src python tools/fleet_emulate.py > fleet.json
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
    import repro_torch.configs as C
    import repro_torch.serving.cluster as CL
    from repro_torch.core.scheduler import ModelCost

    full = C.get_config(CS.ARCH)
    cost = ModelCost(flops_per_token=2.0 * full.active_params(),
                     kv_bytes_per_token=float(full.kv_bytes_per_token()),
                     weight_bytes=2.0 * full.num_params())
    smoke = C.get_smoke_config(CS.ARCH)
    CL.ModelCost = lambda **kw: cost
    C.get_config = lambda arch: smoke
    CS.DEVICE = "cpu"
    CS.sync = lambda torch: None
    CS.check = lambda cond, msg: None if cond else print("gate:", msg[:200],
                                                         file=sys.stderr)

    def unprofiled(torch, fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0, 0.0

    CS._device_busy = unprofiled
    torch.set_num_threads(4)
    CS.phase_e2e_fleet(torch, {"smi": "cpu", "peaks": CS.card_peaks("")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
