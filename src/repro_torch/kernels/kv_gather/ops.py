"""Wrapper of K1, the fused descriptor-table KV transfer.

``kv_transfer`` runs the plain version (``ref.kv_transfer_ref``) when its
tensors lie on the CPU, and launches the CUDA kernel
(``csrc/kv_transfer.cu``) when they lie on a GPU — there is no fallback
between the two. ``kv_transfer.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kv_gather.ref import kv_transfer_ref


def _check(src_pool: torch.Tensor, dst_pool: torch.Tensor,
           src_pages: torch.Tensor, dst_pages: torch.Tensor) -> None:
    if src_pool.shape[-1] != dst_pool.shape[-1]:
        raise ValueError(f"src/dst page payloads differ: {src_pool.shape[-1]} "
                         f"vs {dst_pool.shape[-1]}")
    if src_pool.dtype != dst_pool.dtype:
        raise TypeError(f"kv_transfer is a byte copy: src dtype {src_pool.dtype} "
                        f"!= dst dtype {dst_pool.dtype}; cast the source first")
    if src_pool.untyped_storage().data_ptr() == dst_pool.untyped_storage().data_ptr():
        raise ValueError("kv_transfer: src and dst share storage")
    if src_pages.shape != dst_pages.shape or src_pages.dim() != 1:
        raise ValueError("src_pages / dst_pages must be equal-length 1-D tables")
    if not dst_pool.is_contiguous():
        raise ValueError("kv_transfer writes in place: dst must be contiguous")


def kv_transfer(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                src_pages: torch.Tensor, dst_pages: torch.Tensor) -> torch.Tensor:
    """Execute one descriptor table in one launch, in place on ``dst_pool``.

    Both pools are viewed as flat ``(num_pages, payload)`` page tables (so
    FLOWKV and VLLM pools work on either side); ``dst[dst_pages[i]] =
    src[src_pages[i]]``. Returns ``dst_pool``.
    """
    _check(src_pool, dst_pool, src_pages, dst_pages)
    devs = {t.device for t in (src_pool, dst_pool, src_pages, dst_pages)}
    if len(devs) != 1:
        raise ValueError(f"kv_transfer tensors span devices {sorted(map(str, devs))}")
    dev = dst_pool.device
    if dev.type == "cpu":
        return kv_transfer_ref(src_pool, dst_pool, src_pages, dst_pages)
    if dev.type != "cuda":
        raise ValueError(f"kv_transfer: unsupported device {dev}")
    from repro_torch.kernels import build

    if not src_pool.is_contiguous():
        raise ValueError("kv_transfer: src must be contiguous")
    if src_pages.dtype != torch.int32 or dst_pages.dtype != torch.int32:
        raise TypeError("kv_transfer: page tables must be int32")
    n = int(src_pages.shape[0])
    if n == 0:
        return dst_pool
    src_pages = src_pages.contiguous()
    dst_pages = dst_pages.contiguous()
    row_bytes = src_pool.shape[-1] * src_pool.element_size()
    with torch.cuda.device(dev):
        err = build.library().kv_transfer_launch(
            src_pool.data_ptr(), dst_pool.data_ptr(), src_pages.data_ptr(),
            dst_pages.data_ptr(), n, row_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "kv_transfer")
    kv_transfer.launches += 1
    return dst_pool


kv_transfer.launches = 0
