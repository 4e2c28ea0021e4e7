"""Plain PyTorch version of K4, causal GQA prefill attention with a suffix
mode. Port of ``repro/kernels/flash_prefill/ref.py``.

Direct softmax attention: the whole (S, T) score matrix in fp32, the
softmax weights cast to ``v``'s dtype before the combine, as the reference
oracle does. The wrapper in ``ops.py`` runs it on CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernel against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,KV,hd) -> (B,S,H,hd).

    ``q_offset`` (suffix mode): query row i sits at global position
    ``q_offset + i`` over keys 0..T — the prefix-reuse oracle.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    if causal:
        qpos = q_offset + torch.arange(s, device=q.device)[:, None]
        mask = torch.arange(t, device=q.device)[None, :] <= qpos
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(b, s, h, hd)


def flash_prefill_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, q_offset: int = 0,
                            keys_per_split: int = 512) -> torch.Tensor:
    """The fp32 CUDA kernel's split arithmetic in plain PyTorch (tests only).

    Keys are cut into runs of ``keys_per_split`` counted from key 0; each run
    a row sees (causal: the run starts at or before the row's position)
    gives one fp32 partial (m_s, l_s, unnormalised acc_s) of the softmax
    over its visible keys, and the partials combine in run order: M = max
    m_s, w_s = exp(m_s - M), out = sum w_s acc_s / max(sum w_s l_s, 1e-30).
    Rows are computed one at a time over their visible keys only, so a
    row's bits depend on its position and the keys alone, never on S,
    q_offset or the other rows of the call.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, hd)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    out = torch.empty((b, s, kv, h // kv, hd), dtype=torch.float32, device=q.device)
    for i in range(s):
        end = q_offset + i + 1 if causal else t
        parts = []
        for k0 in range(0, end, keys_per_split):
            sl = slice(k0, min(k0 + keys_per_split, end))
            sc = torch.einsum("bkgd,btkd->bkgt", qg[:, i], kf[:, sl]) / scale
            m_s = sc.amax(dim=-1)
            p = torch.exp(sc - m_s[..., None])
            parts.append((m_s, p.sum(dim=-1), torch.einsum("bkgt,btkd->bkgd", p, vf[:, sl])))
        big_m = parts[0][0]
        for m_s, _, _ in parts[1:]:
            big_m = torch.maximum(big_m, m_s)
        acc, tot = None, None
        for m_s, l_s, acc_s in parts:
            w = torch.exp(m_s - big_m)
            tot = w * l_s if tot is None else tot + w * l_s
            acc = w[..., None] * acc_s if acc is None else acc + w[..., None] * acc_s
        out[:, i] = acc / torch.clamp(tot, min=1e-30)[..., None]
    return out.reshape(b, s, h, hd).to(q.dtype)
