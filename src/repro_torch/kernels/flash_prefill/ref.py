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
