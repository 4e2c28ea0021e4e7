"""Wrappers of K1, the fused descriptor-table KV transfer, and of K5a/K5b,
the whole-block gather and scatter.

Each runs its plain version (``ref.py``) when its tensors lie on the CPU,
and launches its CUDA kernel when they lie on a GPU — there is no fallback
between the two. K1 and K5b launch ``csrc/kv_transfer.cu``; K5b does so at
page granularity (one 64 KiB page per descriptor at qwen3-1.7b's widths,
so every SM shares a block's copy) with a table built on the device. K5a
launches its own block-copy kernel (``csrc/kv_gather.cu``), which reads the
block ids itself and needs no table. Each wrapper counts its own launches
in ``launches``: ``kv_gather`` and ``kv_scatter`` do not add to
``kv_transfer.launches``, K1's launches with one pool in pinned host
memory (the host tier) count in ``kv_transfer.host_launches`` instead, and
its launches over a sharded plan's fine ``(-1, head_dim)`` rows (one shard
pair of a tensor-parallel transfer) go through ``kv_transfer_fine`` and
count there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kv_gather.ref import (kv_gather_ref, kv_scatter_ref,
                                               kv_transfer_ref)


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

    Routes: every tensor on the CPU runs the plain version; both pools on one
    GPU launch K1 (``launches``); one pool on a GPU and the other in pinned
    host memory, with both page tables on that GPU, launch the same kernel
    over the host pool's mapped pages (``host_launches``: the host tier's
    demote and promote). The launch is asynchronous: a CPU read of a host
    pool it wrote must synchronize the stream first. Any other mix of
    devices, and an unpinned host pool beside a GPU one, raises.
    """
    route = _transfer(src_pool, dst_pool, src_pages, dst_pages, "kv_transfer")
    if route == "host":
        kv_transfer.host_launches += 1
    elif route == "card":
        kv_transfer.launches += 1
    return dst_pool


def kv_transfer_fine(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                     src_rows: torch.Tensor, dst_rows: torch.Tensor,
                     head_dim: int) -> torch.Tensor:
    """K1 over fine rows: ``dst[dst_rows[i]] = src[src_rows[i]]`` with both
    pools viewed as ``(-1, head_dim)`` rows, in one launch, in place on
    ``dst_pool`` (one shard pair of a sharded transfer: a kv-head slice of
    each page, ``head_dim`` elements a row). Both pools lie on one device;
    the CPU runs the plain version. Returns ``dst_pool``."""
    if src_pool.device != dst_pool.device:
        raise ValueError(f"kv_transfer_fine: pools on {src_pool.device} and "
                         f"{dst_pool.device}")
    if _transfer(src_pool.view(-1, head_dim), dst_pool.view(-1, head_dim),
                 src_rows, dst_rows, "kv_transfer_fine") == "card":
        kv_transfer_fine.launches += 1
    return dst_pool


def _transfer(src_pool: torch.Tensor, dst_pool: torch.Tensor,
              src_pages: torch.Tensor, dst_pages: torch.Tensor, what: str):
    """K1's routes (see :func:`kv_transfer`): "card" or "host" where a kernel
    was launched, None where the plain version ran or the table was empty."""
    _check(src_pool, dst_pool, src_pages, dst_pages)
    devs = {t.device for t in (src_pool, dst_pool, src_pages, dst_pages)}
    if devs == {torch.device("cpu")}:
        kv_transfer_ref(src_pool, dst_pool, src_pages, dst_pages)
        return None
    gpu = {d for d in devs if d.type == "cuda"}
    if len(gpu) != 1 or not devs <= gpu | {torch.device("cpu")}:
        raise ValueError(f"kv_transfer tensors span devices {sorted(map(str, devs))}")
    dev = gpu.pop()
    if src_pages.device != dev or dst_pages.device != dev:
        raise ValueError(f"kv_transfer: page tables must lie on {dev}, not "
                         f"{src_pages.device} / {dst_pages.device}")
    host = [t.device.type == "cpu" for t in (src_pool, dst_pool)]
    for name, t, on_host in (("src", src_pool, host[0]), ("dst", dst_pool, host[1])):
        if on_host and not t.is_pinned():
            raise ValueError(f"kv_transfer: the host-side {name} pool must be in "
                             "pinned memory (torch.empty(..., pin_memory=True))")
    if not src_pool.is_contiguous():
        raise ValueError("kv_transfer: src must be contiguous")
    if src_pages.dtype != torch.int32 or dst_pages.dtype != torch.int32:
        raise TypeError("kv_transfer: page tables must be int32")
    if any(host):
        launched = _launch_pages(src_pool, dst_pool, src_pages, dst_pages, what,
                                 dev=dev, host=host)
        return "host" if launched else None
    return "card" if _launch_pages(src_pool, dst_pool, src_pages, dst_pages, what) else None


def _launch_pages(src: torch.Tensor, dst: torch.Tensor, src_pages: torch.Tensor,
                  dst_pages: torch.Tensor, what: str, dev=None,
                  host=(False, False)) -> bool:
    """One K1 launch over flat ``(pages, payload)`` views of two contiguous
    pools on ``dev`` (default: dst's GPU); ``host`` marks a side that lies
    in pinned host memory. False (nothing launched) for an empty table."""
    from repro_torch.kernels import build

    n = int(src_pages.shape[0])
    if n == 0:
        return False
    dev = dst.device if dev is None else dev
    src_pages = src_pages.contiguous()
    dst_pages = dst_pages.contiguous()
    row_bytes = src.shape[-1] * src.element_size()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        lib = build.library()
        if any(host):
            err = lib.kv_transfer_host_launch(
                src.data_ptr(), dst.data_ptr(), src_pages.data_ptr(),
                dst_pages.data_ptr(), n, row_bytes, int(host[0]), int(host[1]), stream)
        else:
            err = lib.kv_transfer_launch(
                src.data_ptr(), dst.data_ptr(), src_pages.data_ptr(),
                dst_pages.data_ptr(), n, row_bytes, stream)
    build.check(err, what)
    return True


def _check_blocks(pool: torch.Tensor, block_ids: torch.Tensor, what: str) -> torch.device:
    if pool.dim() != 4 or pool.shape[2] != 2:
        raise ValueError(f"{what}: pool {tuple(pool.shape)} is not (nb, L, 2, payload)")
    if block_ids.dim() != 1:
        raise ValueError(f"{what}: block_ids must be 1-D")
    dev = pool.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda":
        if block_ids.dtype != torch.int32:
            raise TypeError(f"{what}: block_ids must be int32")
        if not pool.is_contiguous():
            raise ValueError(f"{what}: the pool must be contiguous")
    return dev


def _page_table(block_ids: torch.Tensor, pages_per_block: int) -> torch.Tensor:
    """Flat page ids of whole blocks, block-major: (n * pages_per_block,) int32."""
    pages = torch.arange(pages_per_block, dtype=torch.int32, device=block_ids.device)
    return (block_ids[:, None] * pages_per_block + pages[None, :]).reshape(-1)


def kv_gather(pool: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """K5a: ``out[i] = pool[block_ids[i]]``, whole blocks.

    pool (nb, L, 2, payload); block_ids (n,) -> a new (n, L, 2, payload).
    On the card: one launch of the block copy, which reads the ids itself;
    duplicate ids are fine.
    """
    dev = _check_blocks(pool, block_ids, "kv_gather")
    if block_ids.device != dev:
        raise ValueError(f"kv_gather: block_ids on {block_ids.device}, pool on {dev}")
    if dev.type == "cpu":
        return kv_gather_ref(pool, block_ids)
    from repro_torch.kernels import build

    n, (_, L, two, payload) = int(block_ids.shape[0]), pool.shape
    out = torch.empty((n, L, two, payload), dtype=pool.dtype, device=dev)
    block_bytes = L * two * payload * pool.element_size()
    if n == 0 or block_bytes == 0:
        return out
    ids = block_ids.contiguous()
    with torch.cuda.device(dev):
        err = build.library().kv_gather_blocks_launch(
            pool.data_ptr(), out.data_ptr(), ids.data_ptr(), n, block_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "kv_gather")
    kv_gather.launches += 1
    return out


def kv_scatter(pool: torch.Tensor, block_ids: torch.Tensor,
               staging: torch.Tensor) -> torch.Tensor:
    """K5b: ``pool[block_ids[i]] = staging[i]``, in place; blocks not named
    keep their contents.

    pool (nb, L, 2, payload); staging (n, L, 2, payload) in the pool's dtype
    (K1 is a byte copy: the caller casts, as ``write_prefill`` does).
    block_ids (n,) lie on the host, as the block manager hands them out:
    duplicates, which would race on the card, raise there without a device
    sync, and a CUDA pool gets them by an asynchronous upload. Returns ``pool``.
    """
    dev = _check_blocks(pool, block_ids, "kv_scatter")
    n = int(block_ids.shape[0])
    if block_ids.device.type != "cpu":
        raise ValueError(f"kv_scatter: block_ids must lie on the host, not {block_ids.device}")
    if staging.shape != (n, *pool.shape[1:]):
        raise ValueError(f"kv_scatter: staging {tuple(staging.shape)} != "
                         f"({n}, {', '.join(map(str, pool.shape[1:]))})")
    if staging.device != dev:
        raise ValueError(f"kv_scatter: staging on {staging.device}, pool on {dev}")
    if staging.dtype != pool.dtype:
        raise TypeError(f"kv_scatter is a byte copy: staging dtype {staging.dtype} "
                        f"!= pool dtype {pool.dtype}; cast the staging first")
    if torch.unique(block_ids).numel() != n:
        raise ValueError("kv_scatter: duplicate block ids")
    if dev.type == "cpu":
        return kv_scatter_ref(pool, block_ids, staging)
    per = pool.shape[1] * pool.shape[2]
    src_pages = torch.arange(n * per, dtype=torch.int32, device=dev)
    dst_pages = _page_table(block_ids.to(dev, non_blocking=True), per)
    if _launch_pages(staging.contiguous(), pool, src_pages, dst_pages, "kv_scatter"):
        kv_scatter.launches += 1
    return pool


kv_transfer.launches = 0
kv_transfer.host_launches = 0
kv_transfer_fine.launches = 0
kv_gather.launches = 0
kv_scatter.launches = 0
