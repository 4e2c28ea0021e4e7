"""Device-side paged KV cache in the FlowKV block-major layout.
Port of ``repro/serving/kv_cache.py``.

The pool is ONE device tensor ``(num_blocks, L, 2, payload)`` (paper Eq. 5),
updated IN PLACE — where the reference rebinds ``self.pool`` to a new
(donated) array, the port writes into the same storage, so nothing that
holds ``self.pool`` sees stale bytes. The control plane (which blocks
belong to whom) is ``core.block_manager.BlockManager``.

``write_prefill`` / ``gather_dense`` / ``append_token`` bridge between the
model's dense cache format (L, S, KV, hd) and pages. At serving time the
decode plane reads pages in place through the paged kernel and appends the
batch's new K/V with one fused K1 launch (``export_block_tables`` /
``append_tokens`` are its host-side ports).

``num_pool_dispatches`` counts host-issued operations on the pool (dense
bridge calls + fused imports/appends).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.block_manager import BlockManager
from repro_torch.core.layout import KVCacheSpec, KVLayout, alloc_cache
from repro_torch.models.common import ModelConfig


def spec_for_model(cfg: ModelConfig, num_blocks: int,
                   layout: KVLayout = KVLayout.FLOWKV) -> KVCacheSpec:
    return KVCacheSpec(
        num_layers=cfg.num_attention_layers() or cfg.num_layers,
        num_blocks=num_blocks,
        block_size=cfg.block_size,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        dtype=cfg.dtype,
        layout=layout,
    )


class PagedKVCache:
    """One node's paged pool + block manager."""

    def __init__(self, spec: KVCacheSpec, allocator: str = "flowkv",
                 bm: Optional[BlockManager] = None, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.pool = alloc_cache(spec, self.device)
        self.bm = bm if bm is not None else BlockManager(
            spec.num_blocks, spec.block_size, allocator)
        self.num_pool_dispatches = 0     # host-issued operations on the pool

    def _ids(self, blocks: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(blocks), dtype=torch.long).to(self.device)

    # -- write path -------------------------------------------------------------
    def write_prefill(self, request_id: int, k: torch.Tensor, v: torch.Tensor,
                      length: int, start: int = 0) -> List[int]:
        """Store a request's prefill KV. k/v: (L, S, KV, hd), S >= length.

        Blocks must already be allocated. K and V land in ONE pool update
        (whole blocks, all layers). ``start`` (block-aligned) writes a
        SUFFIX: k/v cover tokens ``start..start+length``.
        """
        spec = self.spec
        assert start % spec.block_size == 0, "suffix writes are block-aligned"
        first = start // spec.block_size
        blocks = self.bm.get(request_id)[first:]
        nb = spec.blocks_for_tokens(length)
        assert nb <= len(blocks), (nb, len(blocks))
        pad = nb * spec.block_size - length
        k = k[:, :length]
        v = v[:, :length]
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
        L = spec.num_layers
        # (L, nb, bs, KV, hd) -> (nb, L, bs*KV*hd)
        kp = k.reshape(L, nb, spec.block_size, -1).permute(1, 0, 2, 3).reshape(nb, L, -1)
        vp = v.reshape(L, nb, spec.block_size, -1).permute(1, 0, 2, 3).reshape(nb, L, -1)
        self.pool[self._ids(blocks[:nb])] = torch.stack([kp, vp], dim=2).to(spec.dtype)
        self.num_pool_dispatches += 1
        return blocks[:nb]

    def append_token(self, request_id: int, k_new: torch.Tensor, v_new: torch.Tensor,
                     position: int) -> None:
        """Write one token's K/V (L, KV, hd) at absolute position.

        Reference path only — one pool write PER REQUEST per step. The
        serving decode plane appends the whole batch in one fused launch.
        """
        spec = self.spec
        block = self.bm.get(request_id)[position // spec.block_size]
        slot = position % spec.block_size
        L = spec.num_layers
        pv = self.pool[block].view(L, 2, spec.block_size, -1)
        pv[:, 0, slot] = k_new.reshape(L, -1).to(spec.dtype)
        pv[:, 1, slot] = v_new.reshape(L, -1).to(spec.dtype)
        self.num_pool_dispatches += 1

    def append_tokens(self, request_ids: Sequence[int], k_new: torch.Tensor,
                      v_new: torch.Tensor, positions: Sequence[int]) -> None:
        """Fused batch append: every request's token in ONE K1 launch.

        k_new / v_new (L, B, KV, hd); positions are absolute token indices.
        """
        from repro_torch.kernels.kv_gather import kv_append_tokens

        tables = torch.as_tensor(self.export_block_tables(request_ids)).to(self.device)
        pos = torch.as_tensor(list(positions), dtype=torch.int32).to(self.device)
        kv_append_tokens(self.pool, tables, pos, k_new, v_new,
                         block_size=self.spec.block_size)
        self.num_pool_dispatches += 1

    # -- read path ---------------------------------------------------------------
    def export_block_tables(self, request_ids: Sequence[int]) -> np.ndarray:
        """Padded (B, W) int32 block table, W = the longest table; rows
        shorter than W are zero-padded (the paged kernel masks by length)."""
        tables = [self.bm.get(rid) for rid in request_ids]
        w = max((len(t) for t in tables), default=1)
        out = np.zeros((len(tables), max(1, w)), np.int32)
        for i, t in enumerate(tables):
            out[i, :len(t)] = t
        return out

    def gather_prefix(self, request_id: int, length: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense K/V of a request's first ``length`` tokens — reads ONLY the
        blocks holding them."""
        nb = self.spec.blocks_for_tokens(length)
        return self.gather_dense(request_id, length, num_blocks=nb)

    def gather_dense(self, request_id: int, max_len: int,
                     num_blocks: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rebuild (L, max_len, KV, hd) dense K/V from pages (a copy)."""
        spec = self.spec
        blocks = self.bm.get(request_id)
        if num_blocks is not None:
            blocks = blocks[:num_blocks]
        pages = self.pool.index_select(0, self._ids(blocks))   # (nb, L, 2, payload)
        self.num_pool_dispatches += 1
        nb = pages.shape[0]
        L = spec.num_layers
        pages = pages.reshape(nb, L, 2, spec.block_size, spec.num_kv_heads, spec.head_dim)
        k = pages[:, :, 0].permute(1, 0, 2, 3, 4).reshape(
            L, nb * spec.block_size, spec.num_kv_heads, spec.head_dim)
        v = pages[:, :, 1].permute(1, 0, 2, 3, 4).reshape(
            L, nb * spec.block_size, spec.num_kv_heads, spec.head_dim)
        cur = k.shape[1]
        if cur < max_len:
            k = F.pad(k, (0, 0, 0, 0, 0, max_len - cur))
            v = F.pad(v, (0, 0, 0, 0, 0, max_len - cur))
        return k[:, :max_len], v[:, :max_len]

    # -- transfer path -----------------------------------------------------------
    def import_plan(self, engine, plan, src_pool: torch.Tensor) -> None:
        """Land one transfer plan in this pool as ONE K1 launch, in place."""
        engine.execute(plan, src_pool, self.pool)
        self.num_pool_dispatches += 1

    # -- capacity / bookkeeping -----------------------------------------------------
    @property
    def utilization(self) -> float:
        return self.bm.utilization

    def free(self, request_id: int) -> None:
        self.bm.free(request_id)

    def check_invariants(self) -> None:
        self.bm.check_invariants()


class ShardedKVCache:
    """``tp`` per-shard pools over one block manager (not ported)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedKVCache is not ported yet: see ROADMAP.md item 9")
