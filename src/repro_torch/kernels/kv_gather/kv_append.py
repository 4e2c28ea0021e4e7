"""Fused batched token append (K2): one K1 launch per decode step.

Port of ``repro/kernels/kv_gather/kv_append.py``. The zero-gather decode
step produces one token's K/V per request per layer — ``2 * L * B`` rows of
``num_kv_heads * head_dim`` elements. Viewing the pool at token-slot
granularity ``(nb * L * 2 * block_size, KV*hd)`` turns the whole batch's
append into ONE descriptor table ``staging[i] -> slots[ids[i]]`` run by the
K1 kernel, in place on the pool.

Padded batch lanes must replicate a REAL lane (token/length/block-table
row): duplicate descriptors then write identical bytes to identical slots,
which K1 tolerates, whereas a zero lane would aim its write at block 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kv_gather.ops import kv_transfer


def append_slot_ids(block_tables: torch.Tensor, positions: torch.Tensor,
                    num_layers: int, block_size: int) -> torch.Tensor:
    """Flat token-slot ids for one token per request, all layers and K/V.

    block_tables (B, W) int32; positions (B,) absolute token index.
    Returns (B * L * 2,) int32, row-major over (request, layer, k/v).
    """
    pos = positions.long()
    blk = torch.gather(block_tables.long(), 1, (pos // block_size)[:, None])[:, 0]
    slot = pos % block_size
    dev = block_tables.device
    layer = torch.arange(num_layers, device=dev)[None, :, None]
    kv = torch.arange(2, device=dev)[None, None, :]
    page = (blk[:, None, None] * num_layers + layer) * 2 + kv
    ids = page * block_size + slot[:, None, None]
    return ids.reshape(-1).to(torch.int32)


def stage_tokens(k_new: torch.Tensor, v_new: torch.Tensor) -> torch.Tensor:
    """k/v (L, B, KV, hd) -> staging (B * L * 2, KV*hd), descriptor order."""
    L, B = k_new.shape[0], k_new.shape[1]
    stage = torch.stack([k_new, v_new], dim=2)           # (L, B, 2, KV, hd)
    return stage.permute(1, 0, 2, 3, 4).reshape(B * L * 2, -1)


def kv_append_tokens(pool: torch.Tensor, block_tables: torch.Tensor,
                     positions: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, *, block_size: int) -> torch.Tensor:
    """Append the batch's new-token K/V to the pool in ONE K1 launch.

    pool (nb, L, 2, payload) FlowKV layout, updated in place and returned;
    block_tables (B, W) int32; positions (B,) — the slot each request's
    token occupies; k_new / v_new (L, B, KV, hd).
    """
    nb, L, _, payload = pool.shape
    tok_payload = payload // block_size                # KV * hd
    staging = stage_tokens(k_new, v_new).to(pool.dtype).contiguous()
    ids = append_slot_ids(block_tables, positions, L, block_size)
    src = torch.arange(staging.shape[0], dtype=torch.int32, device=pool.device)
    kv_transfer(staging, pool.view(nb, L, 2, block_size, tok_payload), src, ids)
    return pool
