#!/usr/bin/env python3
"""What ``chip_smoke.py``'s e2e_state consistency gates can test, asked on
the card at full width and depth (float32, random weights from seed 0).

- recurrentgemma-2b (3000-token prompt) and seamless-m4t-large-v2 (1500
  frames, a 32-token decoder prompt), for each scaling of the attention's
  wq / wk / wv on the port's init: the relative max |delta logit| of each
  of 6 decode steps against the prefill of the prompt plus the tokens so
  far (``chip_smoke._decode_vs_prefill``), the planted faults' readings
  (griffin: the newest ring slot zeroed, the position one ahead; seamless:
  the first self K/V zeroed, the cross K rounded to bf16), and the
  distinct tokens of an 8-token greedy stream. ``qk`` is chip_smoke's
  ``_temper_attention`` (wq and wk by sqrt(H / d)).
- mamba2-370m: its prefill logits at ssm_chunk 256 against 100 at prompt
  lengths on and past chunk 100's last boundary, sound and with two
  planted faults (h rounded to bf16 between chunks; h dropped before the
  last chunk).

    python3 tools/state_conditioning_probe.py     # on a machine with an H100 and nvcc

Prints the nvidia-smi name and power limit, then one JSON line per case.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# {variant: (wq and wk factor, wv factor) as multiples of sqrt(H / d)^k}
VARIANTS = {"init": (0, 0), "qk": (1, 0), "qkv": (1, 1)}
CHUNK_LENS = (1100, 1103, 1110, 1125)
STEPS = 6


def _scale(cfg, params, qk_pow, v_pow):
    f = (cfg.num_heads / cfg.d_model) ** 0.5
    stacks = ([params["groups"]["attn"]] if cfg.family == "hybrid"
              else [params["encoder"], params["decoder"]])
    for st in stacks:
        for name, p in (("wq", qk_pow), ("wk", qk_pow), ("wv", v_pow),
                        ("x_wq", qk_pow), ("x_wk", qk_pow), ("x_wv", v_pow)):
            if name in st and p:
                st[name].mul_(f ** p)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.models import encdec as E
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.api import get_model

    if not torch.cuda.is_available():
        print("state_conditioning_probe: no GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = "cuda"

    def tokens(seq):
        return {"tokens": torch.tensor([seq], dtype=torch.int32, device=dev)}

    # mamba2: the chunk gate
    cfg = dataclasses.replace(get_config("mamba2-370m"), dtype=torch.float32)
    model, alt = get_model(cfg), get_model(dataclasses.replace(cfg, ssm_chunk=100))
    params = model.init(0, dev)
    orig = M2._ssd_chunked

    def last_dropped(log_a, Bm, Cm, xdt, h0, chunk):
        ys, h, n = [], h0, log_a.shape[1]
        for c0 in range(0, n, chunk):
            sl = slice(c0, c0 + chunk)
            if c0 > 0 and c0 + chunk >= n:
                h = torch.zeros_like(h)
            y, h = orig(log_a[:, sl], Bm[:, sl], Cm[:, sl], xdt[:, sl], h, chunk)
            ys.append(y)
        return torch.cat(ys, dim=1), h

    for n in CHUNK_LENS:
        prompt = C._prompts(cfg, [n], C.SEED + 1)[0]
        want, _ = model.prefill(params, tokens(prompt))
        got, _ = alt.prefill(params, tokens(prompt))
        row = {"arch": cfg.name, "case": "chunk 256 vs 100", "prompt_len": n,
               "sound": C._rel_err(got, want)}
        for name, fn in (("h_bf16_between_chunks", C._chunked_h_bf16(torch, orig)),
                         ("h_dropped_before_last_chunk", last_dropped)):
            with C._patched(M2, "_ssd_chunked", fn):
                bad, _ = alt.prefill(params, tokens(prompt))
            row[name] = C._rel_err(bad, want)
        print(json.dumps(row), flush=True)
    del params, model, alt
    gc.collect()
    torch.cuda.empty_cache()

    # griffin and seamless: the decode-vs-prefill gate under each scaling
    for arch in ("recurrentgemma-2b", "seamless-m4t-large-v2"):
        cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
        model = get_model(cfg)
        for variant, (qk_pow, v_pow) in VARIANTS.items():
            params = model.init(0, dev)
            _scale(cfg, params, qk_pow, v_pow)
            pad = None
            if cfg.family == "hybrid":
                prompt, batch_of = C._prompts(cfg, [3000], C.SEED + 1)[0], tokens
                plants = {"ring_slot_zeroed": lambda c: C._plant_ring_slot(torch, c),
                          "position_ahead": lambda c: dict(c, length=c["length"] + 1)}
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(C.SEED)
                frames = torch.randn((1, 1500, cfg.d_model), generator=gen, device=dev)
                prompt = C._prompts(cfg, [32], C.SEED)[0]

                def batch_of(seq, frames=frames):
                    return {"frames": frames, **tokens(seq)}

                def pad(cache, cfg=cfg):
                    c = E.init_cache(cfg, 1, 32 + STEPS + 1, 1500, device=dev)
                    n = cache["k"].shape[2]
                    c["k"][:, :, :n] = cache["k"]
                    c["v"][:, :, :n] = cache["v"]
                    c.update(cross_k=cache["cross_k"], cross_v=cache["cross_v"],
                             length=cache["length"].clone())
                    return c
                plants = {"self_kv_0_zeroed": lambda c: C._plant_self_kv(torch, c),
                          "cross_k_bf16": lambda c: dict(
                              c, cross_k=c["cross_k"].to(torch.bfloat16).float())}
            row = {"arch": cfg.name, "variant": variant,
                   "sound": C._decode_vs_prefill(torch, model, params, batch_of, prompt,
                                                 STEPS, pad=pad)}
            for name, plant in plants.items():
                row[name] = max(C._decode_vs_prefill(torch, model, params, batch_of, prompt,
                                                     STEPS, plant=plant, pad=pad))
            stream = C._state_generate(torch, model, params, batch_of(prompt), 8, pad=pad)
            row["distinct_of_8"] = len(set(stream))
            print(json.dumps(row), flush=True)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
