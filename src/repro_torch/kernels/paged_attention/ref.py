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


def paged_decode_attention_split_ref(q: torch.Tensor, pages: torch.Tensor,
                                     block_tables: torch.Tensor, lengths: torch.Tensor,
                                     block_size: int, pages_per_split: int):
    """The CUDA kernel's split arithmetic in plain PyTorch (tests only):
    (out, m, l) as ``paged_decode_attention_stats_ref`` defines them, from
    one fp32 partial (m_s, l_s, unnormalised acc_s) per run of
    ``pages_per_split`` pages counted from page 0, combined in split order:
    M = max m_s, l = sum exp(m_s - M) l_s, out = sum exp(m_s - M) acc_s /
    max(l, 1e-30). Each partial is computed on a fixed (split tokens, KV, hd)
    tile of the row's own pages, so a row's result depends on nothing but
    the row: not on the batch, the other rows or the table width."""
    b, h, hd = q.shape
    width = block_tables.shape[1]
    kv = pages.shape[-1] // (block_size * hd)
    g = h // kv
    span = pages_per_split * block_size
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    out = torch.zeros((b, kv, g, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, kv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g), dtype=torch.float32, device=q.device)
    for r in range(b):
        n_pages = min(-(-max(int(lengths[r]), 0) // block_size), width)
        length = min(max(int(lengths[r]), 0), n_pages * block_size)
        qg = q[r].reshape(kv, g, hd).float()
        parts = []
        for p0 in range(0, n_pages, pages_per_split):
            ids = block_tables[r, p0:min(p0 + pages_per_split, n_pages)].long()
            tile = torch.zeros((2, pages_per_split, block_size, kv, hd), dtype=torch.float32,
                               device=q.device)
            tile[:, :len(ids)] = pages[ids].float().reshape(
                len(ids), 2, block_size, kv, hd).transpose(0, 1)
            k, v = tile.reshape(2, span, kv, hd)
            valid = torch.arange(span, device=q.device) < length - p0 * block_size
            s = torch.einsum("kgd,tkd->kgt", qg, k) / scale
            s = s.masked_fill(~valid, NEG_INF)
            m_s = s.amax(dim=-1)
            p = torch.exp(s - m_s[..., None]).masked_fill(~valid, 0.0)
            parts.append((m_s, p.sum(dim=-1), torch.einsum("kgt,tkd->kgd", p, v)))
        if not parts:
            continue
        big_m = parts[0][0]
        for m_s, _, _ in parts[1:]:
            big_m = torch.maximum(big_m, m_s)
        acc = torch.zeros_like(parts[0][2])
        tot = torch.zeros_like(parts[0][1])
        for m_s, l_s, acc_s in parts:
            e = torch.exp(m_s - big_m)
            tot = tot + e * l_s
            acc = acc + e[..., None] * acc_s
        out[r] = acc / torch.clamp(tot, min=1e-30)[..., None]
        m[r], l[r] = big_m, tot
    return out.reshape(b, h, hd).to(q.dtype), m, l
