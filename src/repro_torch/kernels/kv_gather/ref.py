"""Plain PyTorch versions of K1 (descriptor-table transfer) and its batched
token append. Port of ``repro/kernels/kv_gather/ref.py``.

The wrappers in ``ops.py`` run these on CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernel against them. Unlike the
reference's functional oracles, both update ``dst`` / ``pool`` in place
(the reference donates the destination) and return it.
"""
from __future__ import annotations

import torch


def kv_transfer_ref(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                    src_pages: torch.Tensor, dst_pages: torch.Tensor) -> torch.Tensor:
    """Descriptor-table copy over flat (num_pages, payload) page views."""
    payload = src_pool.shape[-1]
    src_flat = src_pool.reshape(-1, payload)
    dst_flat = dst_pool.view(-1, payload)
    dst_flat[dst_pages.long()] = src_flat[src_pages.long()].to(dst_flat.dtype)
    return dst_pool


def kv_append_ref(pool: torch.Tensor, block_tables, positions, k_new: torch.Tensor,
                  v_new: torch.Tensor, block_size: int) -> torch.Tensor:
    """Batched token-append oracle: per-request slot writes, plain indexing.

    pool (nb, L, 2, payload); block_tables (B, W); positions (B,);
    k_new / v_new (L, B, KV, hd).
    """
    nb, L, _, payload = pool.shape
    tok = payload // block_size
    pv = pool.view(nb, L, 2, block_size, tok)
    for b in range(int(positions.shape[0])):
        pos = int(positions[b])
        blk = int(block_tables[b, pos // block_size])
        slot = pos % block_size
        pv[blk, :, 0, slot] = k_new[:, b].reshape(L, tok).to(pool.dtype)
        pv[blk, :, 1, slot] = v_new[:, b].reshape(L, tok).to(pool.dtype)
    return pool
