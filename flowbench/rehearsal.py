"""A tiny copy of the benchmark for the CPU: the benchmark's folder copied
under ``root`` with one small fp32 configuration, two small mixes (one open
loop, one closed) and their cells, and a BENCHMARK.json naming them. The
harness runs it with ``device="cpu"``; the card is never asked for."""
from __future__ import annotations

import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parent

TINY_CONFIG = {
    "name": "tiny", "source": "test", "reference": "decoder",
    "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 128, "rope_theta": 10000, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": True, "qk_norm": True, "ffn": "gated_mlp",
    "dtype": "float32", "block_size": 8, "flash_threshold": 40, "attn_temper": {},
}
TINY_MOE = dict(TINY_CONFIG, name="tiny-moe", qk_norm=False, ffn="moe_topk",
                intermediate_size=32, num_local_experts=4, num_experts_per_tok=2)
TINY_OPEN = {"name": "tiny-open", "loop": "open", "arrivals": {"dist": "exponential"},
             "prompt_len": {"dist": "lognormal", "median": 40, "sigma": 0.5,
                            "min": 9, "max": 90},
             "output_len": {"dist": "uniform", "min": 3, "max": 10},
             "preroll_s": 0.3, "drain_s": 30}
TINY_CLOSED = {"name": "tiny-closed", "loop": "closed",
               "prompt_len": {"dist": "normal", "mean": 50, "std": 15, "min": 16},
               "output_len": {"dist": "normal", "mean": 12, "std": 3, "min": 4},
               "first_output": "uniform_below", "preroll_cycles": 3, "drain_s": 0}
CHECK = {"tokens": 40, "min_tokens": 10, "budget": 4000, "limit": 1e-3}
CELLS = {
    "tiny.open": ("tiny", "tiny-open", {"rate": 12.0, "num_blocks": 256,
                                        "max_batch_tokens": 32, "trace_slice_s": 0.5,
                                        "warmup": {"prompts": 4, "decode_batch": 3}}),
    "tiny.closed": ("tiny", "tiny-closed", {"clients": 4, "num_blocks": 256,
                                            "max_batch_tokens": 32}),
    "tiny-moe.open": ("tiny-moe", "tiny-open", {"rate": 12.0, "num_blocks": 256,
                                                "max_batch_tokens": 32}),
}


def tiny_root(root: pathlib.Path) -> pathlib.Path:
    """Write the tiny benchmark under ``root`` and return ``root``."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    dst = root / bench["paths"][0]
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cfg in (TINY_CONFIG, TINY_MOE):
        (dst / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for mix in (TINY_OPEN, TINY_CLOSED):
        (dst / "traffic" / f"{mix['name']}.json").write_text(json.dumps(mix))
    names = list(CELLS)
    for name, (_, _, load) in CELLS.items():
        (dst / "cells" / f"{name}.json").write_text(
            json.dumps(dict(load, check=CHECK)))
    bench["configs"] = [{"name": c["name"], "source": "test", "reduced": [], "why": "test",
                         "file": f"{bench['paths'][0]}/configs/{c['name']}.json"}
                        for c in (TINY_CONFIG, TINY_MOE)]
    # a metric listed for cells of a loop is listed for the tiny cells of it
    mixes = {w["name"]: w["traffic"] for w in bench["workloads"]}
    loop_of = {n: json.loads((dst / "traffic" / f"{mixes[n]}.json").read_text())["loop"]
               for n in mixes}
    tiny_loop = {n: (TINY_OPEN if t == TINY_OPEN["name"] else TINY_CLOSED)["loop"]
                 for n, (_, t, _) in CELLS.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            loops = {loop_of[w] for w in m["workloads"]}
            m["workloads"] = [n for n in names if tiny_loop[n] in loops]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for n, (c, t, _) in CELLS.items()]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
