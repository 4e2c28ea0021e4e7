"""Chunked (flash-style) attention in plain PyTorch. Port of
``repro/models/flash.py``.

Windowed prefill attention, and all training attention above
``cfg.flash_threshold`` tokens, go through here so (S, T) score matrices
never materialize (causal serving prefill above the threshold runs the K4
kernel, ``kernels/flash_prefill``, instead; K4 has no backward): queries
are processed in chunks with an fp32 online-softmax accumulator over
key/value chunks. The reference's ``jax.lax.scan`` loops are Python loops
here, and autograd differentiates them. On ``meta`` (the dry-run) without
gradients, the chunk loops run one pass counted for all
(``obs/counting.trips``).

* ``window > 0``  — local attention over a static key span per query chunk;
* ``wedge=True``  — each query chunk contracts only its causal prefix
  (exact causal FLOPs; the training path's ``cfg.attn_wedge``);
* otherwise       — every kv chunk, causal-masked (also what the windowed
  path falls back to when the span covers every key).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.obs.counting import trips

Tensor = torch.Tensor
NEG_INF = torch.finfo(torch.float32).min


def _split_heads(q: Tensor, kvh: int) -> Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, kvh, h // kvh, d)


def _chunk_attend(qg: Tensor, k: Tensor, v: Tensor, mask: Tensor,
                  m_prev: Tensor, l_prev: Tensor, acc: Tensor):
    """One online-softmax accumulation step.

    qg (B,Sq,KV,G,hd); k/v (B,Tc,KV,hd); mask broadcastable to (B,KV,G,Sq,Tc).
    m/l (B,KV,G,Sq); acc (B,Sq,KV,G,hd).
    """
    hd = qg.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    scores = scores.masked_fill(~mask, NEG_INF)
    m_cur = scores.amax(dim=-1)                                  # (B,KV,G,Sq)
    m_new = torch.maximum(m_prev, m_cur)
    # guard fully-masked rows (kept from the reference: NEG_INF is finite)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(scores - m_safe[..., None])
    p = p.masked_fill(~mask, 0.0)
    scale = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe),
                        torch.zeros_like(m_prev))
    l_new = l_prev * scale + p.sum(dim=-1)
    pv = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v).float()
    acc_new = acc * scale.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def _finalize(l: Tensor, acc: Tensor, dtype) -> Tensor:
    denom = torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-30)
    out = acc / denom
    b, s, kv, g, hd = out.shape
    return out.reshape(b, s, kv * g, hd).to(dtype)


def _init_state(b, kvh, g, qc, hd, device):
    return (torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=device),
            torch.zeros((b, qc, kvh, g, hd), dtype=torch.float32, device=device))


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, q_chunk: int = 512, kv_chunk: int = 1024,
                    q_offset: int = 0, wedge: bool = False,
                    _mask_window: int = 0) -> Tensor:
    """q (B,S,H,hd); k,v (B,T,KV,hd) -> (B,S,H,hd).

    ``q_offset``: global position of q[0] relative to k[0] (suffix prefill).
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    if window > 0:
        return _local_flash(q, k, v, window=window, q_chunk=q_chunk, q_offset=q_offset)
    if wedge:
        return _wedge_flash(q, k, v, causal=causal, q_chunk=q_chunk, q_offset=q_offset)

    q_chunk = min(q_chunk, s)
    pad_q = (-s) % q_chunk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    nq = q.shape[1] // q_chunk
    kv_chunk = min(kv_chunk, t)
    pad_k = (-t) % kv_chunk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nk = k.shape[1] // kv_chunk

    dev = q.device
    qpos_base = torch.arange(q_chunk, device=dev)
    kpos_base = torch.arange(kv_chunk, device=dev)
    outs = []
    q_loop = trips(nq, q)             # every chunk has one shape (padded)
    for qi in q_loop:
        qc = _split_heads(q[:, qi * q_chunk:(qi + 1) * q_chunk], kvh)
        qpos = q_offset + qi * q_chunk + qpos_base
        m, l, acc = _init_state(b, kvh, g, q_chunk, hd, dev)
        for ki in trips(nk, q):
            kpos = ki * kv_chunk + kpos_base
            mask = (kpos[None, :] < t).expand(q_chunk, kv_chunk)    # padding
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if _mask_window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - _mask_window)
            kc = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vc = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            m, l, acc = _chunk_attend(qc, kc, vc, mask[None, None, None], m, l, acc)
        outs.append(_finalize(l, acc, q.dtype))
    return torch.cat(outs * q_loop.reps, dim=1)[:, :s]


def _wedge_flash(q, k, v, *, causal: bool, q_chunk: int, q_offset: int):
    """Causal wedge: each query chunk attends to its causal prefix of keys
    only, in one online-softmax step."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    q_chunk = min(q_chunk, s)
    outs = []
    for qi in range(0, s, q_chunk):
        qc_len = min(q_chunk, s - qi)
        qc = _split_heads(q[:, qi:qi + qc_len], kvh)
        hi = min(t, q_offset + qi + qc_len) if causal else t
        qpos = q_offset + qi + torch.arange(qc_len, device=q.device)
        mask = torch.ones((qc_len, hi), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (torch.arange(hi, device=q.device)[None, :] <= qpos[:, None])
        m, l, acc = _init_state(b, kvh, g, qc_len, hd, q.device)
        m, l, acc = _chunk_attend(qc, k[:, :hi], v[:, :hi], mask[None, None, None], m, l, acc)
        outs.append(_finalize(l, acc, q.dtype))
    return torch.cat(outs, dim=1)


def _local_flash(q, k, v, *, window: int, q_chunk: int, q_offset: int):
    """Sliding-window causal attention, O(S * (window + q_chunk))."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    q_chunk = min(q_chunk, s)
    span = window + q_chunk
    if span >= t:
        return flash_attention(q, k, v, causal=True, window=0,
                               q_chunk=q_chunk, kv_chunk=max(128, min(1024, t)),
                               q_offset=q_offset, _mask_window=window)
    pad_q = (-s) % q_chunk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    nq = q.shape[1] // q_chunk
    qpos_base = torch.arange(q_chunk, device=q.device)
    kpos_base = torch.arange(span, device=q.device)
    outs = []
    for qi in range(nq):
        qc = _split_heads(q[:, qi * q_chunk:(qi + 1) * q_chunk], kvh)
        qstart = q_offset + qi * q_chunk
        start = min(max(qstart - window + 1, 0), t - span)
        kc, vc = k[:, start:start + span], v[:, start:start + span]
        qpos = qstart + qpos_base
        kpos = start + kpos_base
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - window)
        m, l, acc = _init_state(b, kvh, g, q_chunk, hd, q.device)
        m, l, acc = _chunk_attend(qc, kc, vc, mask[None, None, None], m, l, acc)
        outs.append(_finalize(l, acc, q.dtype))
    return torch.cat(outs, dim=1)[:, :s]
