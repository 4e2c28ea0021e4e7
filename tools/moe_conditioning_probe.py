#!/usr/bin/env python3
"""How the scale of granite-moe-1b-a400m's random attention weights decides
what ``chip_smoke.py``'s e2e_moe_tp token gate can test, asked on the card
at full width and depth (float32, random weights from seed 0).

Each variant multiplies the port's init (``get_model(cfg).init(0)``) per
attention leaf; ``init`` is the init's own scale and ``tempered`` is
``chip_smoke.MOE_ATTN_SCALE``. For each, on e2e_moe_tp's four prompts:

- the monolithic greedy streams (8 tokens) and their distinct tokens;
- the smallest relative router margin, (p_k - p_k+1) / p_k between the
  k-th and (k+1)-th router probability (k = top_k), over every routing
  decision of those runs;
- the decode steps' mean attention and MoE output norms (what each adds
  to the residual stream);
- on one prefilled state, the first decode step's max |delta logit|: paged
  at TP 1 against the dense decode_step, and paged at TP 2 / 4 against TP
  1; the sharded prefill of the 1100-token prompt at TP 2 / 4 against TP 1;
- the planted faults of e2e_moe_tp (shard 1's K3 or K4 output rounded to
  bf16 at TP 2) against the same references;
- whether the served tokens at TP 1, 2 -> 2 and 2 -> 4 equal the streams.

    python3 tools/moe_conditioning_probe.py     # on a machine with an H100 and nvcc

Prints the nvidia-smi name and power limit, then one JSON line per variant.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# {variant: {leaf: factor}} on the port's init
VARIANTS = {
    "init": {},
    "init_scores_small_output": {"wv": 1 / 8, "wo": 1 / 4},
    "fan_in": {"wq": 1 / 8, "wk": 1 / 8, "wv": 1 / 8, "wo": 1 / 4},
    "tempered": None,                    # chip_smoke.MOE_ATTN_SCALE
    "scores_x4_fan_in_output": {"wq": 1 / 4, "wk": 1 / 4, "wv": 1 / 8, "wo": 1 / 4},
    "scores_x8_fan_in_output": {"wq": 8 ** 0.5 / 8, "wk": 8 ** 0.5 / 8, "wv": 1 / 8,
                                "wo": 1 / 4},
}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("moe_conditioning_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch.kernels.flash_prefill as k4
    import repro_torch.kernels.paged_attention as k3
    from repro_torch.configs import get_config
    from repro_torch.distributed import tp as tp_mod
    from repro_torch.kernels import build
    from repro_torch.models import attention as A
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    cfg = dataclasses.replace(get_config(cs.MOE_ARCH), dtype=torch.float32)
    prompts = cs._prompts(cfg, cs.PROMPT_LENS, cs.SEED)
    b = len(prompts)
    top_k, decode_attention, ffn = MOE._top_k, A.decode_self_attention, T._ffn
    rec = {}

    def top_k_rec(probs, k):
        s = torch.sort(probs, dim=-1, descending=True).values
        rec["margin"].append(((s[..., k - 1] - s[..., k]) / s[..., k - 1]).min())
        return top_k(probs, k)

    def decode_attention_rec(*args, **kw):
        out = decode_attention(*args, **kw)
        rec["attn"].append(out[0].float().norm(dim=-1).mean())
        return out

    def ffn_rec(lp, x, cfg_):
        out = ffn(lp, x, cfg_)
        if x.shape[1] == 1:
            rec["moe"].append(out.float().norm(dim=-1).mean())
        return out

    def delta(got, want) -> float:
        return float((got - want).abs().max())

    for name, scale in VARIANTS.items():
        scale = cs.MOE_ATTN_SCALE if scale is None else scale
        params = get_model(cfg).init(cs.SEED, cs.DEVICE)
        for leaf, factor in scale.items():
            params["layers"][leaf].mul_(factor)
        rec = {"margin": [], "attn": [], "moe": []}
        MOE._top_k, A.decode_self_attention, T._ffn = top_k_rec, decode_attention_rec, ffn_rec
        try:
            mono = cs._monolithic(torch, cfg, params, prompts)
        finally:
            MOE._top_k, A.decode_self_attention, T._ffn = top_k, decode_attention, ffn
        row = dict(variant=name, scale=scale, streams=mono,
                   distinct_tokens=[len(set(s)) for s in mono],
                   min_router_rel_margin=float(torch.stack(rec["margin"]).min()),
                   decode_attn_norm=float(torch.stack(rec["attn"]).mean()),
                   decode_moe_norm=float(torch.stack(rec["moe"]).mean()))
        steps = cs._first_steps(torch, cfg, params, prompts, (1, 2, 4))
        row["tp1_paged_vs_dense_step"] = delta(steps[1], steps["dense"])
        for tp in (2, 4):
            row[f"tp{tp}_first_decode_step"] = delta(steps[tp], steps[1])
        kv, bt, tok, ln = cs._paged_state(torch, cfg, params, prompts, 2)
        with cs._planted_bf16(torch, k3, "paged_decode_attention", 2):
            bad = cs._step_fn(torch, cfg, params, kv, bt, tok, ln, 2)()[:b]
        row["planted_k3_bf16_tp2_step"] = delta(bad, steps[1])
        del kv, steps
        p = torch.tensor([prompts[2]], dtype=torch.int32, device=cs.DEVICE)
        want = T.prefill(params, cfg, p)[0]
        for tp in (2, 4):
            got = tp_mod.sharded_prefill(tp_mod.shard_params(params, cfg, tp), cfg, p)[0]
            row[f"tp{tp}_prefill_1100"] = delta(got, want)
        with cs._planted_bf16(torch, k4, "flash_prefill_op", 2):
            bad = tp_mod.sharded_prefill(tp_mod.shard_params(params, cfg, 2), cfg, p)[0]
        row["planted_k4_bf16_tp2_prefill_1100"] = delta(bad, want)
        for tpd in cs.MOE_TP:
            client, handles, _, _ = cs._moe_serve(torch, cfg, params, prompts, tpd, 2048)
            row[f"served_{tpd[0]}->{tpd[1]}_equal"] = \
                [list(map(int, h.request.output_tokens)) for h in handles] == mono
            del client, handles
        print(json.dumps(row), flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
