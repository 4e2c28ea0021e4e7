#!/usr/bin/env python3
"""Two questions that ``chip_smoke.py``'s sim_calibrate phase leaves open,
asked on the card at full width (qwen3-1.7b, random weights from seed 0).

1. **Would the router decide otherwise under a profile fitted on the
   card?** The profiles: the stock ``H100`` (data sheet) and each fit of
   ``chip_smoke.calibrate_on_card`` that is physical (a positive slope and
   an effective rate at most the peak: the device-time fit, and the wall
   fit where it passes). Under each, two runs served through ``PDCluster``
   on the card: e2e_prefix's staggered serve (fp32, 1P+1D, a 1056-token
   prefix, followers of +96 / +200 / +400 tokens) and sim_calibrate's tier
   run (bf16, 1P+1D, 48 pool and 128 pinned host blocks, a donor, a
   1400-token churn prompt, a follower of +200). Printed for each: the
   tokens each follower reused and the prefix fetches.
2. **Does K4 pay below ``flash_threshold`` (1024)?** At 256-1024 tokens
   the bf16 prefill on the plain attention path and with K4
   (``flash_threshold=0``): the minimum wall of 5 synchronized calls, in
   the order plain, K4, K4, plain, and one profiled call's device time by
   part (``chip_smoke._profile_split``).

    python3 tools/calibrate_probe.py     # on a machine with an H100 and nvcc

Prints the nvidia-smi name and power limit, then one JSON line per part.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHORT_LENS = (256, 512, 768, 1024)
REPEATS = 5


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("calibrate_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.sim.hardware import H100

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    cfg = get_config(cs.ARCH)
    params = get_model(cfg).init(cs.SEED, cs.DEVICE)

    # 2. K4 below flash_threshold
    def min_wall_ms(fn) -> float:
        fn()
        walls = []
        for _ in range(REPEATS):
            cs.sync(torch)
            t0 = time.perf_counter()
            fn()
            cs.sync(torch)
            walls.append(time.perf_counter() - t0)
        return min(walls) * 1e3

    k4_cfg = dataclasses.replace(cfg, flash_threshold=0)
    rows = []
    for n in SHORT_LENS:
        paths = {"plain": cs.prefill_fn(torch, params, cfg, n),
                 "k4": cs.prefill_fn(torch, params, k4_cfg, n)}
        walls = {k: [] for k in paths}
        for k in ("plain", "k4", "k4", "plain"):
            walls[k].append(min_wall_ms(paths[k]))
        row = {"prompt_len": n, "wall_ms": walls}
        for k, fn in paths.items():
            reset_launch_counts()
            p = cs._profile_split(torch, fn)
            row[k] = dict(device_ms=p["device_ms"], split_ms=p["split_ms"],
                          k4_launches=launch_counts()["flash_prefill"])
        cs.check(row["plain"]["k4_launches"] == 0 and
                 row["k4"]["k4_launches"] >= cfg.num_layers,
                 f"calibrate_probe: K4 launches at {n}: {row}")
        rows.append(row)
    print(json.dumps({"part": "k4_below_threshold", "card": smi.stdout.strip(),
                      "rows": rows}), flush=True)

    # 1. the router under the stock and the fitted profiles
    c = cs.calibrate_on_card(torch, cfg, params)
    profiles = {"stock": H100}
    for k in ("device_fit", "wall_fit"):
        if c[k]["status"] == "fitted":
            profiles[k] = c[k]["profile"]
    fits = {k: {n: v for n, v in c[k].items() if n != "profile"}
            for k in ("wall_fit", "device_fit")}
    tier_prompts = cs.sim_tier_prompts(cfg)
    decisions = {name: {} for name in profiles}
    for name, hw in profiles.items():
        cluster, reqs, _ = cs._tier_run(torch, cfg, params, tier_prompts, cs.TIER_HOST_BLOCKS,
                                        hw, num_decode=1)
        decisions[name]["tier_run"] = dict(
            follower_cached=reqs[-1].num_cached_prefix_tokens,
            prefix_fetches=cluster.stats()["prefix_fetches"])
        del cluster
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)  # e2e_prefix's model and prompts
    params32 = get_model(cfg32).init(cs.SEED, cs.DEVICE)
    rng = np.random.RandomState(cs.SEED + 1)
    prefix = rng.randint(0, cfg.vocab_size, size=cs.PREFIX_LEN).tolist()
    prompts = [prefix + rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in [cs.DONOR_TAIL] + cs.FOLLOWER_TAILS]
    for name, hw in profiles.items():
        cluster, reqs, *_ = cs._staggered(torch, cfg32, params32, prompts, hardware=hw)
        decisions[name]["e2e_prefix"] = dict(
            follower_tails=cs.FOLLOWER_TAILS,
            followers_cached=[r.num_cached_prefix_tokens for r in reqs[1:]],
            prefix_fetches=cluster.stats()["prefix_fetches"])
        del cluster
    print(json.dumps({"part": "routing", "card": smi.stdout.strip(), "fits": fits,
                      "profiles": {k: dataclasses.asdict(v) for k, v in profiles.items()},
                      "decisions": decisions}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
