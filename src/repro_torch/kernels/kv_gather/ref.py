"""Plain PyTorch versions of K1 (descriptor-table transfer), its batched
token append, and K5a/K5b (whole-block gather and scatter). Port of
``repro/kernels/kv_gather/ref.py``.

The wrappers in ``ops.py`` run these on CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernel against them. Unlike the
reference's functional oracles, the writers update ``dst`` / ``pool`` in
place (the reference donates the destination) and return it.
"""
from __future__ import annotations

import torch


def kv_gather_ref(pool: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """pool (nb, L, 2, payload); block_ids (n,) -> staging (n, L, 2, payload)."""
    return pool.index_select(0, block_ids.long())


def kv_scatter_ref(pool: torch.Tensor, block_ids: torch.Tensor,
                   staging: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`kv_gather_ref`: place staged blocks into the pool."""
    pool[block_ids.long()] = staging.to(pool.dtype)
    return pool


def kv_transfer_ref(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                    src_pages: torch.Tensor, dst_pages: torch.Tensor) -> torch.Tensor:
    """Descriptor-table copy over flat (num_pages, payload) page views; the
    two pools may lie on different devices (the host tier's moves)."""
    payload = src_pool.shape[-1]
    src_flat = src_pool.reshape(-1, payload)
    dst_flat = dst_pool.view(-1, payload)
    rows = src_flat[src_pages.long().to(src_flat.device)]
    dst_flat[dst_pages.long().to(dst_flat.device)] = rows.to(dst_flat.device, dst_flat.dtype)
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
