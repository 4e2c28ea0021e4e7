"""Plain PyTorch reference of the decoder-only configurations: a frozen copy
of the dense qk-norm GQA block (Qwen3) and of the fp32-routed top-k MoE FFN
(Granite MoE), written from the published equations and the port's
parameter layout. It imports nothing of the program.

* :func:`make_weights` makes a configuration's weights on the device from a
  seed, in the port's layout (layer leaves stacked on a leading axis, ``wq``
  ``(L, d, H, hd)``, ``wo`` ``(L, H, hd, d)``, experts ``(L, E, d, f)``), in
  the type they are served in. The same tensors go to the program and here.
* :func:`logits_at` is the reference: float32 everywhere, TF32 off, no
  cache, computed layer by layer over the whole sequence with attention in
  blocks of query rows. It returns the logits at the rows asked for.
* ``quant="fp8"`` is the control: the same forward with every linear
  layer's weight (per output channel) and input (per row) rounded to fp8
  e4m3 before an fp32 product, the precision step below bf16.

Norms store ``1 + gain`` as the port does, so a gain of 0 is the identity.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
Q_ROWS = 1024          # query rows a block of attention (scores: H x 1024 x T fp32)
FP8 = torch.float8_e4m3fn


def dims(cfg: Dict) -> Dict[str, int]:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    return {"L": cfg["num_hidden_layers"], "d": d, "H": h,
            "KV": cfg["num_key_value_heads"], "hd": cfg.get("head_dim") or d // h,
            "V": cfg["vocab_size"], "ff": cfg["intermediate_size"],
            "E": cfg.get("num_local_experts", 0), "k": cfg.get("num_experts_per_tok", 0)}


def layer_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Each stacked layer leaf's shape, in the port's layout."""
    m = dims(cfg)
    L, d, H, KV, hd, ff = m["L"], m["d"], m["H"], m["KV"], m["hd"], m["ff"]
    shapes = {"wq": (L, d, H, hd), "wk": (L, d, KV, hd), "wv": (L, d, KV, hd),
              "wo": (L, H, hd, d)}
    if cfg["ffn"] == "moe_topk":
        E = m["E"]
        shapes.update(moe_router=(L, d, E), moe_w_gate=(L, E, d, ff),
                      moe_w_up=(L, E, d, ff), moe_w_down=(L, E, ff, d))
    else:
        shapes.update(w_gate=(L, d, ff), w_up=(L, d, ff), w_down=(L, ff, d))
    return shapes


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """Random weights from ``seed`` on ``device``, one ``randn`` a leaf: scale
    ``shape[-2] ** -0.5`` (the port's init convention), the embedding 0.02,
    the norms' gains 0; then ``attn_temper`` scales named attention leaves."""
    dev = torch.device(device)
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    m = dims(cfg)

    def randn(shape, scale):
        out = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return out.mul_(scale).to(dtype)

    layers = {name: randn(shape, shape[-2] ** -0.5)
              for name, shape in layer_shapes(cfg).items()}
    for name, factor in cfg.get("attn_temper", {}).items():
        layers[name].mul_(factor)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    if cfg.get("qk_norm"):
        layers["q_norm"] = zeros(m["L"], m["hd"])
        layers["k_norm"] = zeros(m["L"], m["hd"])
    layers["norm_attn"] = zeros(m["L"], m["d"])
    layers["norm_mlp"] = zeros(m["L"], m["d"])
    params = {"embed": randn((m["V"], m["d"]), 0.02), "final_norm": zeros(m["d"]),
              "layers": layers}
    if not cfg.get("tie_word_embeddings", True):
        params["unembed"] = randn((m["V"], m["d"]), 0.02)
    return params


# ---------------------------------------------------------------------------
# The forward, in float32
# ---------------------------------------------------------------------------
def _rms(x: Tensor, gain: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + gain.float())


def _rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x (S, heads, hd), rotate-half RoPE at positions ``pos`` (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _linear(x: Tensor, w: Tensor, quant: Optional[str]) -> Tensor:
    """x (N, i) @ w (i, o) in fp32; under ``quant="fp8"`` both operands are
    rounded to e4m3 first (w per output column, x per row)."""
    w = w.float()
    if quant == "fp8":
        x = _fp8(x, dim=-1)
        w = _fp8(w, dim=0)
    elif quant is not None:
        raise ValueError(f"unknown control precision {quant!r}")
    return x @ w


def _fp8(t: Tensor, dim: int) -> Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = torch.finfo(FP8).max / amax
    return (t * scale).to(FP8).float() / scale


def _attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal GQA attention, q (S, H, hd), k/v (S, KV, hd), by blocks of rows."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).transpose(0, 1)        # (H, S, hd)
    vv = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for lo in range(0, s, Q_ROWS):
        hi = min(s, lo + Q_ROWS)
        sc = torch.einsum("qhd,htd->hqt", q[lo:hi], kk[:, :hi]) / math.sqrt(hd)
        mask = torch.arange(hi, device=q.device)[None, :] > \
            torch.arange(lo, hi, device=q.device)[:, None]
        sc.masked_fill_(mask[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqt,htd->qhd", torch.softmax(sc, dim=-1), vv[:, :hi])
    return out


def _gated(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor, quant) -> Tensor:
    return _linear(F.silu(_linear(x, wg, quant)) * _linear(x, wu, quant), wd, quant)


def _moe(x: Tensor, lp: Dict, k: int, quant) -> Tensor:
    """Top-k MoE: fp32 softmax router, the top k renormalised, each token
    through its k experts only."""
    probs = torch.softmax(_linear(x, lp["moe_router"], quant), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(x)
    for e in range(lp["moe_router"].shape[-1]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _gated(x[rows], lp["moe_w_gate"][e], lp["moe_w_up"][e], lp["moe_w_down"][e],
                   quant)
        out.index_add_(0, rows, y * top_p[rows, slot, None])
    return out


@torch.no_grad()
def logits_at(params: Dict, cfg: Dict, tokens: Iterable[int], rows: Iterable[int],
              quant: Optional[str] = None) -> Tensor:
    """Logits (len(rows), V) fp32 of the sequence ``tokens`` at ``rows``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = dims(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    dev = params["embed"].device
    tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    pos = torch.arange(tok.numel(), device=dev)
    x = params["embed"][tok].float()
    lay = params["layers"]
    for i in range(m["L"]):
        lp = {name: leaf[i] for name, leaf in lay.items()}
        h = _rms(x, lp["norm_attn"], eps)
        q = _linear(h, lp["wq"].reshape(m["d"], -1), quant).unflatten(-1, (m["H"], m["hd"]))
        k = _linear(h, lp["wk"].reshape(m["d"], -1), quant).unflatten(-1, (m["KV"], m["hd"]))
        v = _linear(h, lp["wv"].reshape(m["d"], -1), quant).unflatten(-1, (m["KV"], m["hd"]))
        if cfg.get("qk_norm"):
            q = _rms(q, lp["q_norm"], eps)
            k = _rms(k, lp["k_norm"], eps)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        a = _attention(q, k, v).flatten(-2)
        x = x + _linear(a, lp["wo"].reshape(-1, m["d"]), quant)
        h = _rms(x, lp["norm_mlp"], eps)
        if cfg["ffn"] == "moe_topk":
            x = x + _moe(h, lp, m["k"], quant)
        else:
            x = x + _gated(h, lp["w_gate"], lp["w_up"], lp["w_down"], quant)
        del q, k, v, a, h
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
    xr = _rms(x[idx], params["final_norm"], eps)
    table = params.get("unembed", params["embed"])
    return _linear(xr, table.t(), quant)
