"""Closed-form work of the decoder configurations, from the configuration
file alone: the operations and bytes that the requests need, never what an
implementation happens to compute (a dense MoE dispatch's 32 experts a token
count as the top-k they are).

Conventions: a multiply-add is 2 operations; attention is QK^T and PV, so
4 * hd operations a (query, key) pair a head; a chunk of ``n`` prompt tokens
after ``o`` resident ones has ``n * o + n * (n + 1) / 2`` causal pairs; the
LM head runs on the one row that predicts the next token. Norms, RoPE and
softmax are left out, as in the usual MFU count.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional

ROOT = pathlib.Path(__file__).resolve().parent
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
PEAK_KEY = {"bfloat16": "bf16_flops", "float16": "fp16_flops", "float32": "fp32_flops"}


def peaks(device_name: str) -> Dict:
    """The table of published peaks for ``device_name`` (peaks.json)."""
    table = json.loads((ROOT / "peaks.json").read_text())
    if device_name not in table:
        raise KeyError(f"no published peaks for {device_name!r} in peaks.json")
    return table[device_name]


def _dims(cfg: Dict):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return (cfg["num_hidden_layers"], d, h, cfg["num_key_value_heads"],
            cfg.get("head_dim") or d // h)


def layer_params_active(cfg: Dict) -> int:
    """Weights a token multiplies through in one layer (top-k experts only)."""
    _, d, h, kv, hd = _dims(cfg)
    attn = 2 * d * h * hd + 2 * d * kv * hd
    ff = cfg["intermediate_size"]
    if cfg["ffn"] == "moe_topk":
        e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
        return attn + d * e + k * 3 * d * ff
    return attn + 3 * d * ff


def body_params_active(cfg: Dict) -> int:
    return cfg["num_hidden_layers"] * layer_params_active(cfg)


def head_flops(cfg: Dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def attn_pair_flops(cfg: Dict) -> float:
    """Operations of one (query, key) pair summed over layers and heads."""
    layers, _, h, _, hd = _dims(cfg)
    return 4.0 * layers * h * hd


def causal_pairs(offset: int, n: int) -> float:
    return n * offset + n * (n + 1) / 2.0


def chunk_flops(cfg: Dict, offset: int, n: int, final: bool) -> float:
    """A prefill chunk of ``n`` tokens after ``offset`` resident ones."""
    return (2.0 * body_params_active(cfg) * n
            + attn_pair_flops(cfg) * causal_pairs(offset, n)
            + (head_flops(cfg) if final else 0.0))


def decode_flops(cfg: Dict, context: int) -> float:
    """One decode token over ``context`` cached tokens (and itself)."""
    return (2.0 * body_params_active(cfg) + attn_pair_flops(cfg) * (context + 1)
            + head_flops(cfg))


def kv_bytes_per_token(cfg: Dict) -> int:
    layers, _, _, kv, hd = _dims(cfg)
    return 2 * layers * kv * hd * DTYPE_BYTES[cfg["dtype"]]


def k4_chunk_cost(cfg: Dict, offset: int, n: int) -> Optional[Dict[str, float]]:
    """Causal prefill attention of one chunk over all layers (K4's work):
    operations, and bytes of q, k, v read once and out written once. None
    where the chunk's length keeps it off K4 (``flash_threshold``)."""
    if offset + n <= cfg["flash_threshold"]:
        return None
    layers, _, h, kv, hd = _dims(cfg)
    b = DTYPE_BYTES[cfg["dtype"]]
    return {"flops": attn_pair_flops(cfg) * causal_pairs(offset, n),
            "bytes": float(layers * b * hd * (2 * n * h + 2 * (offset + n) * kv))}


def roofline_pct(cost: Dict[str, float], seconds: float, peak: Dict, dtype: str) -> float:
    """The least time the card could take (the larger of operations over the
    peak rate and bytes over the peak bandwidth) as a share of ``seconds``."""
    rate = peak[PEAK_KEY[dtype]]
    least = max(cost["flops"] / rate, cost["bytes"] / peak["hbm_bytes_s"])
    return 100.0 * least / seconds
