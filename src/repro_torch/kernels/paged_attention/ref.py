"""Plain PyTorch versions of K3, the FlowKV-layout paged decode attention.
Port of ``repro/kernels/paged_attention/ref.py``.

``pages`` is one layer's plane ``(nb, 2, payload)`` — possibly the strided
view ``pool[:, layer]``: indexing it by block id gathers only the named
pages, never the whole plane.
"""
from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min


def _gather_kv(pages, block_tables, block_size, hd):
    b, maxb = block_tables.shape
    kv = pages.shape[-1] // (block_size * hd)
    gathered = pages[block_tables.reshape(-1).long()]
    gathered = gathered.reshape(b, maxb, 2, block_size, kv, hd)
    k = gathered[:, :, 0].reshape(b, maxb * block_size, kv, hd)
    v = gathered[:, :, 1].reshape(b, maxb * block_size, kv, hd)
    return k, v, kv


def paged_decode_attention_ref(q: torch.Tensor, pages: torch.Tensor,
                               block_tables: torch.Tensor, lengths: torch.Tensor,
                               block_size: int) -> torch.Tensor:
    """q (B, H, hd); pages (nb, 2, payload); block_tables (B, maxb);
    lengths (B,) -> (B, H, hd)."""
    b, h, hd = q.shape
    k, v, kv = _gather_kv(pages, block_tables, block_size, hd)
    g = h // kv
    qg = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    t = k.shape[1]
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w.to(v.dtype), v)
    return out.reshape(b, h, hd)


def paged_decode_attention_stats_ref(q: torch.Tensor, pages: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     lengths: torch.Tensor, block_size: int):
    """``return_stats`` oracle: (out, m, l) with the fp32 softmax state per
    (B, KV, G). A length-0 row yields out = 0, m = finfo(f32).min, l = 0."""
    b, h, hd = q.shape
    k, v, kv = _gather_kv(pages, block_tables, block_size, hd)
    g = h // kv
    qg = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    t = k.shape[1]
    valid = (torch.arange(t, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    out = out / torch.clamp(l, min=1e-30)[..., None]
    m = torch.where(lengths[:, None, None] > 0, m, torch.full_like(m, NEG_INF))
    return out.reshape(b, h, hd).to(q.dtype), m, l
