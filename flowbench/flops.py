"""Closed-form work of the decoder configurations, from the configuration
file alone: the operations and bytes that the requests need, never what an
implementation happens to compute (a dense MoE dispatch's 32 experts a token
count as the top-k they are).

Conventions: a multiply-add is 2 operations; the LM head runs on the one row
that predicts the next token. Norms, RoPE, softmax, gates, decays and the
Mamba-2 causal convolution (elementwise, 4 taps) are left out, as in the
usual MFU count.

**Layers.** The file's ``layer_types`` lists each layer's mixer,
``"attention"`` or ``"mamba"``; without it every layer is attention. Every
layer has the file's FFN (``ffn``): ``gated_mlp`` (3 d f weights),
``moe_topk`` (the router's d E and the top-k experts' k 3 d f;
``intermediate_size`` is one expert's width) or ``none``; plus a shared
gated expert of ``shared_intermediate_size`` where that is given.

**Attention** (d, H heads, KV heads of hd): projections 2 d H hd + 2 d KV hd;
QK^T and PV are 4 hd operations a (query, key) pair a head; a chunk of ``n``
prompt tokens after ``o`` resident ones has ``n o + n (n + 1) / 2`` causal
pairs; K/V is 2 KV hd values a token a layer.

**Mamba-2 / SSD** (arXiv:2405.21060, section 6, with the published keys
``mamba_n_heads`` H, ``mamba_d_head`` P, ``mamba_d_state`` N,
``mamba_n_groups`` G, ``mamba_d_conv`` K, ``mamba_chunk_size`` Q):

* in projection d (2 H P + 2 G N + H) (z, x, B, C, dt) and out projection
  H P d weights, 2 operations a weight a token;
* a decode token: the state update h = a h + x B^T (2 H P N) and the read
  y = h C (2 H P N), so ``4 H P N``;
* a prefill chunk is cut into SSD chunks of Q tokens from its start (the
  last one shorter, ``q``): inside one, C B^T on its causal pairs (2 G N a
  pair) and the masked product with X (2 H P a pair); the chunk's state
  B^T X (2 H P N a token) and the carried state's read C h (2 H P N a
  token). So ``4 H P N q + 2 (G N + H P) q (q + 1) / 2`` a SSD chunk;
* the state a request holds: fp32 h of H P N values and the conv tail of
  (K - 1) (H P + 2 G N) values in the served type, a layer.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parent
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
PEAK_KEY = {"bfloat16": "bf16_flops", "float16": "fp16_flops", "float32": "fp32_flops"}
KINDS = ("attention", "mamba")


def peaks(device_name: str) -> Dict:
    """The table of published peaks for ``device_name`` (peaks.json)."""
    table = json.loads((ROOT / "peaks.json").read_text())
    if device_name not in table:
        raise KeyError(f"no published peaks for {device_name!r} in peaks.json")
    return table[device_name]


def layer_kinds(cfg: Dict) -> List[str]:
    """Each layer's mixer, ``"attention"`` or ``"mamba"``."""
    kinds = cfg.get("layer_types") or ["attention"] * cfg["num_hidden_layers"]
    if len(kinds) != cfg["num_hidden_layers"]:
        raise ValueError(f"layer_types lists {len(kinds)} layers, num_hidden_layers "
                         f"is {cfg['num_hidden_layers']}")
    unknown = sorted(set(kinds) - set(KINDS))
    if unknown:
        raise ValueError(f"unknown layer types {unknown}; known: {list(KINDS)}")
    return list(kinds)


def num_layers_of(cfg: Dict, kind: str) -> int:
    return layer_kinds(cfg).count(kind)


def _attn_dims(cfg: Dict):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return d, h, cfg["num_key_value_heads"], cfg.get("head_dim") or d // h


def _ssd_dims(cfg: Dict):
    return (cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"],
            cfg.get("mamba_n_groups", 1))


def ffn_params_active(cfg: Dict) -> int:
    """FFN weights a token multiplies through in one layer (top-k experts
    only, the shared expert included)."""
    d, ff = cfg["hidden_size"], cfg.get("intermediate_size", 0)
    shared = 3 * d * cfg.get("shared_intermediate_size", 0)
    if cfg["ffn"] == "moe_topk":
        e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
        return d * e + k * 3 * d * ff + shared
    if cfg["ffn"] == "gated_mlp":
        return 3 * d * ff + shared
    if cfg["ffn"] == "none":
        return shared
    raise ValueError(f"unknown ffn {cfg['ffn']!r}")


def layer_params_active(cfg: Dict, kind: str = "attention") -> int:
    """Weights a token multiplies through in one layer of ``kind``."""
    d = cfg["hidden_size"]
    if kind == "attention":
        _, h, kv, hd = _attn_dims(cfg)
        mixer = 2 * d * h * hd + 2 * d * kv * hd
    elif kind == "mamba":
        H, P, N, G = _ssd_dims(cfg)
        mixer = d * (2 * H * P + 2 * G * N + H) + H * P * d
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    return mixer + ffn_params_active(cfg)


def body_params_active(cfg: Dict) -> int:
    return sum(layer_params_active(cfg, k) for k in layer_kinds(cfg))


def head_flops(cfg: Dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def attn_pair_flops(cfg: Dict) -> float:
    """Operations of one (query, key) pair summed over attention layers and
    heads."""
    layers = num_layers_of(cfg, "attention")
    if layers == 0:
        return 0.0
    _, h, _, hd = _attn_dims(cfg)
    return 4.0 * layers * h * hd


def causal_pairs(offset: int, n: int) -> float:
    return n * offset + n * (n + 1) / 2.0


def ssd_decode_flops(cfg: Dict) -> float:
    """The SSD state update and read of one decode token, every Mamba-2 layer."""
    layers = num_layers_of(cfg, "mamba")
    if layers == 0:
        return 0.0
    H, P, N, _ = _ssd_dims(cfg)
    return 4.0 * layers * H * P * N


def ssd_chunk_flops(cfg: Dict, n: int) -> float:
    """The SSD products of a prefill chunk of ``n`` tokens, every Mamba-2
    layer: its SSD chunks of ``mamba_chunk_size`` from the chunk's start."""
    layers = num_layers_of(cfg, "mamba")
    if layers == 0:
        return 0.0
    H, P, N, G = _ssd_dims(cfg)
    q = cfg["mamba_chunk_size"]
    full, rest = divmod(n, q)
    pairs = full * causal_pairs(0, q) + causal_pairs(0, rest)
    return layers * (4.0 * H * P * N * n + 2.0 * (G * N + H * P) * pairs)


def chunk_flops(cfg: Dict, offset: int, n: int, final: bool) -> float:
    """A prefill chunk of ``n`` tokens after ``offset`` resident ones."""
    return (2.0 * body_params_active(cfg) * n
            + attn_pair_flops(cfg) * causal_pairs(offset, n)
            + (head_flops(cfg) if final else 0.0)
            + ssd_chunk_flops(cfg, n))


def decode_flops(cfg: Dict, context: int) -> float:
    """One decode token over ``context`` cached tokens (and itself)."""
    return (2.0 * body_params_active(cfg) + attn_pair_flops(cfg) * (context + 1)
            + head_flops(cfg) + ssd_decode_flops(cfg))


def kv_bytes_per_token(cfg: Dict) -> int:
    """K/V bytes a token, attention layers only."""
    layers = num_layers_of(cfg, "attention")
    if layers == 0:
        return 0
    _, _, kv, hd = _attn_dims(cfg)
    return 2 * layers * kv * hd * DTYPE_BYTES[cfg["dtype"]]


def state_bytes_per_request(cfg: Dict) -> int:
    """Recurrent state bytes a request holds whatever its length: each
    Mamba-2 layer's fp32 h and its conv tail in the served type."""
    layers = num_layers_of(cfg, "mamba")
    if layers == 0:
        return 0
    H, P, N, G = _ssd_dims(cfg)
    tail = (cfg["mamba_d_conv"] - 1) * (H * P + 2 * G * N) * DTYPE_BYTES[cfg["dtype"]]
    return layers * (4 * H * P * N + tail)


def k4_chunk_cost(cfg: Dict, offset: int, n: int) -> Optional[Dict[str, float]]:
    """Causal prefill attention of one chunk over all attention layers (K4's
    work): operations, and bytes of q, k, v read once and out written once.
    None where the chunk's length keeps it off K4 (``flash_threshold``) or
    the configuration has no attention layer."""
    layers = num_layers_of(cfg, "attention")
    if offset + n <= cfg["flash_threshold"] or layers == 0:
        return None
    _, h, kv, hd = _attn_dims(cfg)
    b = DTYPE_BYTES[cfg["dtype"]]
    return {"flops": attn_pair_flops(cfg) * causal_pairs(offset, n),
            "bytes": float(layers * b * hd * (2 * n * h + 2 * (offset + n) * kv))}


def roofline_pct(cost: Dict[str, float], seconds: float, peak: Dict, dtype: str) -> float:
    """The least time the card could take (the larger of operations over the
    peak rate and bytes over the peak bandwidth) as a share of ``seconds``."""
    rate = peak[PEAK_KEY[dtype]]
    least = max(cost["flops"] / rate, cost["bytes"] / peak["hbm_bytes_s"])
    return 100.0 * least / seconds
