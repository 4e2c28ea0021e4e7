"""Wrapper of K4, causal GQA flash attention for prefill (cold and suffix).

``flash_prefill_op`` runs the plain version (``ref.flash_prefill_ref``) when
its tensors lie on the CPU, and launches the CUDA kernel
(``csrc/flash_prefill.cu``) when they lie on a GPU — there is no fallback
between the two. The kernel masks its own ragged edges, so nothing is
padded. ``flash_prefill_op.launches`` counts kernel launches and
``flash_prefill_op.suffix_launches`` those of them with ``q_offset > 0``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_MAX_GROUP = 64


def flash_prefill_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,KV,hd) with ``T == S + q_offset`` -> (B,S,H,hd).

    ``q_offset = 0`` is ordinary causal prefill; ``q_offset > 0`` is SUFFIX
    prefill: the first ``q_offset`` keys are a resident prefix and the
    result is rows ``q_offset..T`` of the full-sequence attention.
    """
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    assert t == s + q_offset, "keys must cover prefix (q_offset) + queries"
    if not causal and q_offset:
        raise ValueError("q_offset is causal-only")
    if h % kvh or v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not form GQA attention")
    dev = q.device
    if dev.type == "cpu":
        return flash_prefill_ref(q, k, v, causal=causal, q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_prefill_op: unsupported device {dev}")
    from repro_torch.kernels import build

    if k.device != dev or v.device != dev:
        raise ValueError(f"q on {dev}, k on {k.device}, v on {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        "takes float32 or bfloat16, the same for all three")
    if hd not in _HEAD_DIMS or h // kvh > _MAX_GROUP:
        raise ValueError(f"kernel supports hd in {_HEAD_DIMS} and G <= {_MAX_GROUP}; "
                         f"got hd={hd}, G={h // kvh}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if s == 0 or b == 0:
        return out
    q, k, v = (_aligned(x) for x in (q, k, v))
    with torch.cuda.device(dev):
        err = build.library().flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kvh, hd, q_offset, int(causal), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "flash_prefill")
    flash_prefill_op.launches += 1
    if q_offset:
        flash_prefill_op.suffix_launches += 1
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned (the kernel loads 16-byte vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


flash_prefill_op.launches = 0
flash_prefill_op.suffix_launches = 0
