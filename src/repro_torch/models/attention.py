"""Attention blocks: GQA/MQA with optional qk-norm, causal masks, dense-cache
decode and the zero-gather paged decode. Port of ``repro/models/attention.py``.

Two attention scales live here, exactly as in the reference: the dense path
divides scores by ``sqrt(hd)`` rounded to ``q.dtype`` (11.3125 in bf16 for
hd=128), while the paged kernel and :func:`merge_inflight_token` divide by
an fp32 ``sqrt(hd)``. :func:`attend` also casts the softmax weights to
``q.dtype`` before the combine.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig, apply_rope, rms_norm

Tensor = torch.Tensor
NEG_INF = torch.finfo(torch.float32).min


def attn_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd), "wo": (h, hd, d)}
    if cfg.qk_norm:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


def attn_param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    axes = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qk_norm:
        axes["q_norm"] = ("head_dim",)
        axes["k_norm"] = ("head_dim",)
    return axes


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def _proj(x: Tensor, w: Tensor) -> Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def qkv_project(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), with RoPE + qk-norm.

    Without RoPE (``use_rope=False``, NoPE) positions are unused. A score
    scale other than 1/sqrt(hd) (``attn_scale``) is folded into q, so every
    attention path (plain, K4, K3) keeps dividing by sqrt(hd)."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_scale:
        q = q * (cfg.attn_scale * math.sqrt(cfg.head_dim))
    return q, k, v


def out_project(p: Dict[str, Tensor], attn: Tensor) -> Tensor:
    """einsum('bshk,hkd->bsd') as one matmul."""
    h, k, d = p["wo"].shape
    return torch.matmul(attn.flatten(-2), p["wo"].reshape(h * k, d))


# ---------------------------------------------------------------------------
# Core attention math (GQA-aware)
# ---------------------------------------------------------------------------
def _gqa_scores(q: Tensor, k: Tensor) -> Tensor:
    """q (B,S,H,hd), k (B,T,KV,hd) -> scores (B,KV,G,S,T) with H = KV*G."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / scale


def _gqa_combine(weights: Tensor, v: Tensor) -> Tensor:
    """weights (B,KV,G,S,T), v (B,T,KV,hd) -> (B,S,H,hd)."""
    b, kvh, g, s, t = weights.shape
    out = torch.einsum("bkgst,btkd->bskgd", weights, v)
    return out.reshape(b, s, kvh * g, v.shape[-1])


def causal_mask(s: int, t: int, offset: int = 0, window: int = 0,
                device=None) -> Tensor:
    """(s, t) boolean mask; query i (global pos offset+i) sees key j iff
    j <= offset+i and (window == 0 or j > offset+i-window)."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def attend(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Full-precision softmax attention. mask broadcastable to (B,KV,G,S,T)."""
    scores = _gqa_scores(q, k).float()
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_combine(weights, v)


# ---------------------------------------------------------------------------
# Layer-level entry points
# ---------------------------------------------------------------------------
def self_attention_heads(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                         positions: Tensor, window: int = 0, *, train: bool = False
                         ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """:func:`self_attention` minus the output projection.

    Above ``cfg.flash_threshold`` tokens the reference leaves plain
    attention for flash attention. Serving takes the K4 kernel
    (``kernels/flash_prefill``) there; windowed attention, which K4 does
    not take, and training (``train=True``: K4 has no backward) take the
    chunked ``models/flash.py``, as the reference does.
    """
    q, k, v = qkv_project(p, x, cfg, positions)
    s = x.shape[1]
    if window > 0 or s > cfg.flash_threshold:
        out = _flash(q, k, v, cfg, window, 0, train)
    else:
        mask = causal_mask(s, s, 0, window, x.device)[None, None, None]
        out = attend(q, k, v, mask)
    return out, (k, v)


def _flash(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig, window: int,
           offset: int, train: bool = False) -> Tensor:
    """The flash branch of prefill: K4 for causal serving attention, the
    chunked ``models/flash.py`` for windowed attention and for training."""
    if window == 0 and not train:
        from repro_torch.kernels.flash_prefill import flash_prefill_op
        return flash_prefill_op(q, k, v, causal=True, q_offset=offset)
    from repro_torch.models.flash import flash_attention
    return flash_attention(q, k, v, causal=True, window=window,
                           q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
                           q_offset=offset, wedge=cfg.attn_wedge)


def self_attention(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                   positions: Tensor, window: int = 0, *, train: bool = False
                   ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Full-sequence causal self-attention (prefill, or training with
    ``train=True``); returns (out, (k, v))."""
    out, (k, v) = self_attention_heads(p, x, cfg, positions, window, train=train)
    return out_project(p, out), (k, v)


def suffix_attention(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                     positions: Tensor, prefix_k: Tensor, prefix_v: Tensor,
                     window: int = 0) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Suffix-only prefill attention over a resident prefix (see the
    reference): rows C..C+S_suf of full-prompt attention, with the same
    flash/dense dispatch keyed on the TOTAL length."""
    out, (k, v) = suffix_attention_heads(p, x, cfg, positions, prefix_k,
                                         prefix_v, window)
    return out_project(p, out), (k, v)


def suffix_attention_heads(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                           positions: Tensor, prefix_k: Tensor,
                           prefix_v: Tensor, window: int = 0
                           ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """:func:`suffix_attention` minus the output projection."""
    q, k, v = qkv_project(p, x, cfg, positions)
    k_full = torch.cat([prefix_k.to(k.dtype), k], dim=1)
    v_full = torch.cat([prefix_v.to(v.dtype), v], dim=1)
    s, t = x.shape[1], k_full.shape[1]
    offset = prefix_k.shape[1]
    if window > 0 or t > cfg.flash_threshold:
        out = _flash(q, k_full, v_full, cfg, window, offset)
    else:
        mask = causal_mask(s, t, offset, window, x.device)[None, None, None]
        out = attend(q, k_full, v_full, mask)
    return out, (k, v)


def decode_self_attention(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                          cache_k: Tensor, cache_v: Tensor, position: Tensor,
                          window: int = 0) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Single-token decode against a dense cache.

    x (B, 1, D); cache_k/v (B, T, KV, hd); position (B,) is the write index.
    The new token's K/V is written into ``cache_k``/``cache_v`` IN PLACE
    (the reference returns updated copies); they are returned as well.
    """
    b = x.shape[0]
    pos = torch.as_tensor(position, device=x.device).broadcast_to((b,)).long()
    q, k_new, v_new = qkv_project(p, x, cfg, pos[:, None])
    b_idx = torch.arange(b, device=x.device)
    cache_k[b_idx, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[b_idx, pos] = v_new[:, 0].to(cache_v.dtype)
    t = cache_k.shape[1]
    kpos = torch.arange(t, device=x.device)[None, :]
    valid = kpos <= pos[:, None]
    if window > 0:
        valid &= kpos > (pos[:, None] - window)
    mask = valid[:, None, None, None, :]          # (B,1,1,1,T)
    out = attend(q, cache_k, cache_v, mask)
    return out_project(p, out), (cache_k, cache_v)


def decode_paged_self_attention(p: Dict[str, Tensor], x: Tensor,
                                cfg: ModelConfig, pages: Tensor,
                                block_tables: Tensor, position: Tensor,
                                *, layer: int = 0
                                ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Single-token decode directly against the FlowKV pool (zero-gather).

    ``pages`` is either one layer's plane ``(nb, 2, payload)`` or — what the
    decode step passes — the whole pool ``(nb, L, 2, payload)`` with
    ``layer``; the paged kernel reads the layer through the pool's strides,
    so no ``pool[:, layer]`` copy is made. Returns (out (B, 1, D),
    (k_new (B, KV, hd), v_new (B, KV, hd))).
    """
    out, kv = decode_paged_attention_heads(p, x, cfg, pages, block_tables,
                                           position, layer=layer)
    return out_project(p, out), kv


def decode_paged_attention_heads(p: Dict[str, Tensor], x: Tensor,
                                 cfg: ModelConfig, pages: Tensor,
                                 block_tables: Tensor, position: Tensor,
                                 *, layer: int = 0
                                 ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """:func:`decode_paged_self_attention` minus the output projection."""
    from repro_torch.kernels.paged_attention import paged_decode_attention

    pool = pages.unsqueeze(1) if pages.dim() == 3 else pages
    pos = torch.as_tensor(position, device=x.device).broadcast_to((x.shape[0],))
    q, k_new, v_new = qkv_project(p, x, cfg, pos[:, None])
    q1, k1, v1 = q[:, 0], k_new[:, 0], v_new[:, 0]
    out_old, m_old, l_old = paged_decode_attention(
        q1, pool, layer, block_tables, pos, block_size=cfg.block_size,
        return_stats=True)
    out = merge_inflight_token(q1, k1, v1, out_old, m_old, l_old, x.dtype)
    return out, (k1, v1)


def merge_inflight_token(q1: Tensor, k1: Tensor, v1: Tensor, out_old: Tensor,
                         m_old: Tensor, l_old: Tensor, out_dtype) -> Tensor:
    """Fold the in-flight token into paged-kernel output as one extra key.

    q1 (B,H,hd), k1/v1 (B,KV,hd); out_old (B,H,hd) + m_old/l_old (B,KV,G)
    are the kernel's online-softmax state. Returns (B,1,H,hd).
    """
    b, h, hd = q1.shape
    kvh = k1.shape[1]
    g = h // kvh
    qg = q1.reshape(b, kvh, g, hd).float()
    s_self = torch.einsum("bkgd,bkd->bkg", qg, k1.float())
    s_self = s_self / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    m_new = torch.maximum(m_old, s_self)
    alpha = torch.exp(m_old - m_new)
    p_self = torch.exp(s_self - m_new)
    l_new = l_old * alpha + p_self
    acc = (out_old.reshape(b, kvh, g, hd).float() * (l_old * alpha)[..., None]
           + p_self[..., None] * v1.float()[:, :, None, :])
    out = acc / torch.clamp(l_new, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(out_dtype)


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------
def cross_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd), "wo": (h, hd, d)}


def cross_attention(p: Dict[str, Tensor], x: Tensor, memory_kv: Tuple[Tensor, Tensor],
                    cfg: ModelConfig, memory_mask: Optional[Tensor] = None) -> Tensor:
    """x (B,S,D) attends over precomputed encoder K/V (B,T,KV,hd)."""
    q = _proj(x, p["wq"])
    k, v = memory_kv
    mask = None if memory_mask is None else memory_mask[:, None, None, None, :]
    return out_project(p, attend(q, k, v, mask))


def encode_memory(p: Dict[str, Tensor], memory: Tensor) -> Tuple[Tensor, Tensor]:
    """Project encoder output once into cross-attention K/V (per request)."""
    return _proj(memory, p["wk"]), _proj(memory, p["wv"])
