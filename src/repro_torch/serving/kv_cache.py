"""Device-side paged KV cache in the FlowKV block-major layout.
Port of ``repro/serving/kv_cache.py``.

The pool is ONE device tensor ``(num_blocks, L, 2, payload)`` (paper Eq. 5),
updated IN PLACE — where the reference rebinds ``self.pool`` to a new
(donated) array, the port writes into the same storage, so nothing that
holds ``self.pool`` sees stale bytes. The control plane (which blocks
belong to whom) is ``core.block_manager.BlockManager``.

``write_prefill`` / ``gather_dense`` / ``append_token`` bridge between the
model's dense cache format (L, S, KV, hd) and pages; the first two move
whole blocks through K5b (``kv_scatter``) and K5a (``kv_gather``), one
launch each. At serving time the
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
from repro_torch.kernels.kv_gather import kv_gather, kv_scatter
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
        return torch.as_tensor(list(blocks), dtype=torch.int32).to(self.device,
                                                                    non_blocking=True)

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
        kv = torch.stack([kp, vp], dim=2).to(spec.dtype)      # (nb, L, 2, payload)
        kv_scatter(self.pool, torch.as_tensor(blocks[:nb], dtype=torch.int32), kv)
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
        pages = kv_gather(self.pool, self._ids(blocks))        # (nb, L, 2, payload)
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
    """``tp`` per-shard pools over ONE block manager, all on one device.

    Shard ``s`` holds the FLOWKV pool for its contiguous kv-head slice —
    same ``(num_blocks, L, 2, ·)`` geometry, payload ``block_size *
    (num_kv_heads/tp) * head_dim``. Page ids are GLOBAL: one BlockManager
    allocates for all shards (a request's block i is block i in every
    shard's pool), which lets a cross-degree transfer plan address both
    sides with one descriptor table (``core/transfer.ShardedTransferEngine``)
    and keeps the leak audit a single-control-plane problem.

    The dense bridge (write/gather) presents FULL-width K/V to callers and
    slices/concatenates on the kv-head axis at the boundary: each shard
    writes its slice through K5b and gathers through K5a, so the engine's
    prefill, spill and prefix-reuse paths are shard-agnostic.

    ``num_pool_dispatches`` counts host-issued operations per ROLE, not per
    shard (one decode step is one, though it touches ``tp`` pools);
    ``shard_dispatches`` counts the per-(src_shard, dst_shard)-pair
    transfer launches landed here.
    """

    def __init__(self, spec: KVCacheSpec, tp: int, allocator: str = "flowkv",
                 device=None):
        from repro_torch.core.transfer import ShardSpec, shard_slice_spec

        self.spec = spec                       # FULL-width spec
        self.tp = tp
        self.device = resolve_device(device)
        self.shard_spec = ShardSpec(tp, spec.num_kv_heads)
        self.bm = BlockManager(spec.num_blocks, spec.block_size, allocator)
        self.shards = [
            PagedKVCache(shard_slice_spec(spec, self.shard_spec), allocator,
                         bm=self.bm, device=self.device)
            for _ in range(tp)]
        self.num_pool_dispatches = 0
        self.shard_dispatches = 0              # per-shard-pair transfer lands

    @property
    def pools(self) -> List[torch.Tensor]:
        return [s.pool for s in self.shards]

    def _head_slices(self, arr: torch.Tensor, axis: int) -> List[torch.Tensor]:
        width = arr.shape[axis] // self.tp
        return [arr.narrow(axis, s * width, width) for s in range(self.tp)]

    # -- write path -------------------------------------------------------------
    def write_prefill(self, request_id: int, k: torch.Tensor, v: torch.Tensor,
                      length: int, start: int = 0) -> List[int]:
        """Full-width (L, S, KV, hd) K/V: each shard writes its head slice."""
        blocks: List[int] = []
        for shard, k_s, v_s in zip(self.shards, self._head_slices(k, 2),
                                   self._head_slices(v, 2)):
            blocks = shard.write_prefill(request_id, k_s, v_s, length, start=start)
        self.num_pool_dispatches += 1
        return blocks

    def append_token(self, request_id: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, position: int) -> None:
        for shard, k_s, v_s in zip(self.shards, self._head_slices(k_new, 1),
                                   self._head_slices(v_new, 1)):
            shard.append_token(request_id, k_s, v_s, position)
        self.num_pool_dispatches += 1

    def append_tokens(self, request_ids: Sequence[int], k_new: torch.Tensor,
                      v_new: torch.Tensor, positions: Sequence[int]) -> None:
        for shard, k_s, v_s in zip(self.shards, self._head_slices(k_new, 2),
                                   self._head_slices(v_new, 2)):
            shard.append_tokens(request_ids, k_s, v_s, positions)
        self.num_pool_dispatches += 1

    # -- read path ---------------------------------------------------------------
    def export_block_tables(self, request_ids: Sequence[int]) -> np.ndarray:
        return self.shards[0].export_block_tables(request_ids)

    def gather_prefix(self, request_id: int, length: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        nb = self.spec.blocks_for_tokens(length)
        return self.gather_dense(request_id, length, num_blocks=nb)

    def gather_dense(self, request_id: int, max_len: int,
                     num_blocks: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        parts = [s.gather_dense(request_id, max_len, num_blocks=num_blocks)
                 for s in self.shards]
        self.num_pool_dispatches += 1
        return (torch.cat([k for k, _ in parts], dim=2),
                torch.cat([v for _, v in parts], dim=2))

    # -- transfer path -----------------------------------------------------------
    def import_plan(self, engine, plan, src_pools: Sequence[torch.Tensor]) -> None:
        """Land a sharded transfer plan: one K1 launch per shard pair.

        ``engine`` is a :class:`~repro_torch.core.transfer.ShardedTransferEngine`;
        ``src_pools`` are the source node's per-shard pools (any tp degree).
        """
        before = engine.num_dispatches
        engine.execute(plan, list(src_pools), self.pools)
        landed = engine.num_dispatches - before
        self.shard_dispatches += landed
        self.num_pool_dispatches += landed

    # -- capacity / bookkeeping -----------------------------------------------------
    @property
    def utilization(self) -> float:
        return self.bm.utilization

    def free(self, request_id: int) -> None:
        self.bm.free(request_id)

    def check_invariants(self) -> None:
        self.bm.check_invariants()
