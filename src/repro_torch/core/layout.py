"""KV-cache layouts and the FlowKV layout transform (paper Eq. 5).
Port of ``repro/core/layout.py``.

    VLLM layout:   K,V : (L, 2, B, H)   — layer-major baseline
    FLOWKV layout: K,V : (B, L, 2, H)   — block-major

``H`` is the flattened per-(layer, k/v, block) payload
``block_size * num_kv_heads * head_dim``. Pools are torch tensors; the
block writers update them in place (the reference returns new arrays).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Tuple

import torch

from repro_torch import resolve_device


class KVLayout(enum.Enum):
    VLLM = "vllm"        # (L, 2, B, H)  — layer-major baseline
    FLOWKV = "flowkv"    # (B, L, 2, H)  — block-major, paper Eq. 5

    @property
    def block_axis(self) -> int:
        return 2 if self is KVLayout.VLLM else 0


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static description of one node's paged KV pool."""

    num_layers: int
    num_blocks: int
    block_size: int          # tokens per block
    num_kv_heads: int
    head_dim: int
    dtype: Any = torch.bfloat16
    layout: KVLayout = KVLayout.FLOWKV

    @property
    def payload(self) -> int:
        """H — elements per (layer, k/v, block)."""
        return self.block_size * self.num_kv_heads * self.head_dim

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.layout is KVLayout.VLLM:
            return (self.num_layers, 2, self.num_blocks, self.payload)
        return (self.num_blocks, self.num_layers, 2, self.payload)

    @property
    def bytes_per_block(self) -> int:
        """Bytes moved when one block (all layers, K+V) is transferred."""
        return self.num_layers * 2 * self.payload * self.dtype.itemsize

    @property
    def bytes_per_token(self) -> int:
        return self.bytes_per_block // self.block_size

    @property
    def total_bytes(self) -> int:
        return self.num_blocks * self.bytes_per_block

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return max(1, math.ceil(num_tokens / self.block_size))

    def with_layout(self, layout: KVLayout) -> "KVCacheSpec":
        return dataclasses.replace(self, layout=layout)

    def transfer_calls_per_block(self) -> int:
        """Contiguous-range transfer calls to move ONE block: L*2 vs 1."""
        return self.num_layers * 2 if self.layout is KVLayout.VLLM else 1

    def page_view_shape(self) -> Tuple[int, int, int, int]:
        return (self.num_layers, 2, self.block_size, self.num_kv_heads * self.head_dim)


def alloc_cache(spec: KVCacheSpec, device=None) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype, device=resolve_device(device))


def vllm_to_flowkv(cache: torch.Tensor) -> torch.Tensor:
    """(L, 2, B, H) -> (B, L, 2, H), contiguous."""
    return cache.permute(2, 0, 1, 3).contiguous()


def flowkv_to_vllm(cache: torch.Tensor) -> torch.Tensor:
    """(B, L, 2, H) -> (L, 2, B, H), contiguous."""
    return cache.permute(1, 2, 0, 3).contiguous()


def convert(cache: torch.Tensor, src: KVLayout, dst: KVLayout) -> torch.Tensor:
    if src is dst:
        return cache
    if src is KVLayout.VLLM and dst is KVLayout.FLOWKV:
        return vllm_to_flowkv(cache)
    return flowkv_to_vllm(cache)


def write_block(cache: torch.Tensor, spec: KVCacheSpec, block_id, layer: int,
                k_page: torch.Tensor, v_page: torch.Tensor) -> torch.Tensor:
    """Write one (layer, block) K/V page in place; returns ``cache``."""
    k_flat = k_page.reshape(-1).to(spec.dtype)
    v_flat = v_page.reshape(-1).to(spec.dtype)
    if spec.layout is KVLayout.FLOWKV:
        cache[block_id, layer, 0] = k_flat
        cache[block_id, layer, 1] = v_flat
    else:
        cache[layer, 0, block_id] = k_flat
        cache[layer, 1, block_id] = v_flat
    return cache


def read_block(cache: torch.Tensor, spec: KVCacheSpec, block_id,
               layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (layer, block) K/V page as (block_size, kv_heads, head_dim)."""
    shape = (spec.block_size, spec.num_kv_heads, spec.head_dim)
    if spec.layout is KVLayout.FLOWKV:
        k, v = cache[block_id, layer, 0], cache[block_id, layer, 1]
    else:
        k, v = cache[layer, 0, block_id], cache[layer, 1, block_id]
    return k.reshape(shape), v.reshape(shape)


def gather_blocks(cache: torch.Tensor, spec: KVCacheSpec, block_ids) -> torch.Tensor:
    """Whole blocks (all layers, K+V) as (n, L, 2, H), whatever the layout."""
    idx = torch.as_tensor(block_ids, dtype=torch.long, device=cache.device)
    if spec.layout is KVLayout.FLOWKV:
        return cache.index_select(0, idx)
    return cache.index_select(2, idx).permute(2, 0, 1, 3).contiguous()


def scatter_blocks(cache: torch.Tensor, spec: KVCacheSpec, block_ids,
                   payload: torch.Tensor) -> torch.Tensor:
    """Place (n, L, 2, H) payload into the pool's blocks in place."""
    idx = torch.as_tensor(block_ids, dtype=torch.long, device=cache.device)
    if spec.layout is KVLayout.FLOWKV:
        cache[idx] = payload.to(cache.dtype)
    else:
        cache[:, :, idx, :] = payload.permute(1, 2, 0, 3).to(cache.dtype)
    return cache
