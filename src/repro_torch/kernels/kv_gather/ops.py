"""Wrappers of K1, the fused descriptor-table KV transfer, and of K5a/K5b,
the whole-block gather and scatter.

Each runs its plain version (``ref.py``) when its tensors lie on the CPU,
and launches its CUDA kernel when they lie on a GPU — there is no fallback
between the two. K1 and K5b launch ``csrc/kv_transfer.cu`` in the design
:func:`k1_design` picks from the row width, the table's length, the
alignment and the host side (one block a row; the small-row kernel for long
tables of rows below ``ROWS_BELOW`` bytes), never trying one and falling
back to another; K5b does so at page granularity (one 64 KiB page per
descriptor at qwen3-1.7b's widths) with a table built on the device. K5a
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

import contextlib
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.kv_gather.ref import (kv_gather_ref, kv_scatter_ref,
                                               kv_transfer_ref)


def _check(src_pool: torch.Tensor, dst_pool: torch.Tensor,
           src_pages: torch.Tensor, dst_pages: torch.Tensor, row: int = None) -> None:
    if row is None and src_pool.shape[-1] != dst_pool.shape[-1]:
        raise ValueError(f"src/dst page payloads differ: {src_pool.shape[-1]} "
                         f"vs {dst_pool.shape[-1]}")
    if row is not None and (row <= 0 or src_pool.numel() % row or dst_pool.numel() % row):
        raise ValueError(f"pools of {src_pool.numel()} / {dst_pool.numel()} elements are not "
                         f"rows of {row}")
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
    if src_pool.get_device() != dst_pool.get_device():
        raise ValueError(f"kv_transfer_fine: pools on {src_pool.device} and "
                         f"{dst_pool.device}")
    if _transfer(src_pool, dst_pool, src_rows, dst_rows, "kv_transfer_fine",
                 row=head_dim) == "card":
        kv_transfer_fine.launches += 1
    return dst_pool


def _transfer(src_pool: torch.Tensor, dst_pool: torch.Tensor,
              src_pages: torch.Tensor, dst_pages: torch.Tensor, what: str,
              design: K1Design = None, row: int = None):
    """K1's routes (see :func:`kv_transfer`) over the pools' pages, or over
    rows of ``row`` elements where it is given: "card" or "host" where a
    kernel was launched, None where the plain version ran or the table was
    empty."""
    _check(src_pool, dst_pool, src_pages, dst_pages, row)
    tensors = (src_pool, dst_pool, src_pages, dst_pages)
    # every tensor on one card (a sharded transfer's launch a shard pair)
    # is told apart without building device objects
    if all(t.is_cuda for t in tensors) and len({t.get_device() for t in tensors}) == 1:
        dev, host = None, (False, False)
    else:
        devs = {t.device for t in tensors}
        if devs == {torch.device("cpu")}:
            if row is not None:
                src_pool, dst_pool = src_pool.view(-1, row), dst_pool.view(-1, row)
            kv_transfer_ref(src_pool, dst_pool, src_pages, dst_pages)
            return None
        gpu = {d for d in devs if d.type == "cuda"}
        if len(gpu) != 1 or not devs <= gpu | {torch.device("cpu")}:
            raise ValueError(f"kv_transfer tensors span devices {sorted(map(str, devs))}")
        dev = gpu.pop()
        if src_pages.device != dev or dst_pages.device != dev:
            raise ValueError(f"kv_transfer: page tables must lie on {dev}, not "
                             f"{src_pages.device} / {dst_pages.device}")
        host = (src_pool.device.type == "cpu", dst_pool.device.type == "cpu")
        for name, t, on_host in (("src", src_pool, host[0]), ("dst", dst_pool, host[1])):
            if on_host and not t.is_pinned():
                raise ValueError(f"kv_transfer: the host-side {name} pool must be in "
                                 "pinned memory (torch.empty(..., pin_memory=True))")
    if not src_pool.is_contiguous():
        raise ValueError("kv_transfer: src must be contiguous")
    if src_pages.dtype != torch.int32 or dst_pages.dtype != torch.int32:
        raise TypeError("kv_transfer: page tables must be int32")
    if not _launch(src_pool, dst_pool, src_pages, dst_pages, what, dev=dev, host=host,
                   design=design, row=row):
        return None
    return "host" if any(host) else "card"


# K1's designs (csrc/kv_transfer.cu) and the constants that size them, each
# found by measurement on an H100 with tools/k1_host_ablate.py:
ROWS_BELOW = 2048          # rows narrower than this may take the small-row design,
ROWS_FROM = 1056           # in a table of at least this many rows for each
ROWS_FROM_UNIT = 256       # bytes of row width or part of them (see rows_from)
ROWS_BLOCKS_PER_SM = 8     # small-row grid: blocks a streaming multiprocessor
THREADS = 256              # threads a block, pages and rows (the kernel's kThreads)
ROWS_IN_FLIGHT = 8         # most rows a group keeps in flight (the kernel's kRowsInFlight)
_DESIGN_CODES = {"pages": 0, "rows": 1}


@dataclasses.dataclass(frozen=True)
class K1Design:
    """One K1 launch's design and geometry (see ``csrc/kv_transfer.cu``):
    ``word`` bytes a thread access, ``lanes`` threads a row and
    ``in_flight`` rows a group of them keeps in flight (rows), ``grid``
    blocks (pages: one a row)."""
    design: str
    word: int = 1
    lanes: int = 1
    in_flight: int = 1
    grid: int = 1


def _word(row_bytes: int, align: int) -> int:
    """The widest word that divides the row width and both bases."""
    bits = align | row_bytes
    return next(w for w in (16, 4, 2, 1) if bits % w == 0)


@functools.lru_cache(maxsize=1024)
def k1_design(row_bytes: int, align: int, src_on_host: bool, dst_on_host: bool,
              n: int, sms: int = 132) -> K1Design:
    """K1's design for ``n`` rows of ``row_bytes``: ``align`` is the OR of
    both pools' base addresses (only its low bits count), ``sms`` the card's
    multiprocessors. Rows narrower than ``ROWS_BELOW`` in a table of at least
    :func:`rows_from` rows between two card pools (a sharded plan's fine
    rows) take the small-row design; everything else one block a row: the
    P->D pages, K5b, the decode appends, and the host tier's demote and
    promote. Pure: no tensor, no device."""
    if src_on_host or dst_on_host or row_bytes >= ROWS_BELOW or n < rows_from(row_bytes):
        return block_a_row(row_bytes, align, n)
    return rows_design(row_bytes, _word(row_bytes, align), n, sms)


def rows_from(row_bytes: int) -> int:
    """The fewest rows of ``row_bytes`` for which the small-row design beats
    one block a row: ``ROWS_FROM`` (one wave of page blocks on 132
    multiprocessors) for each ``ROWS_FROM_UNIT`` bytes of row width or part
    of them. A shorter table runs all its rows at once in the page kernel,
    which is then 1.3-1.8x faster (csrc/kv_transfer.cu gives the numbers)."""
    return ROWS_FROM * max(1, -(-row_bytes // ROWS_FROM_UNIT))


def block_a_row(row_bytes: int, align: int, n: int) -> K1Design:
    """One 256-thread block a row in the widest word the alignment allows:
    K1's only design before the small-row one, and the yardstick that
    design is timed beside."""
    return K1Design("pages", word=_word(row_bytes, align), grid=max(1, n))


def rows_design(row_bytes: int, word: int, n: int, sms: int) -> K1Design:
    """The small-row design's geometry for ``n`` rows of ``row_bytes`` in
    ``word``-byte accesses: a group of lanes a row (its words rounded up to a
    power of two, at most a warp), as many rows in flight a group (at most
    ``ROWS_IN_FLIGHT``) as still give every multiprocessor a block, and a
    grid of at most ``ROWS_BLOCKS_PER_SM`` blocks a multiprocessor."""
    words = row_bytes // word
    lanes = min(32, 1 << max(0, words - 1).bit_length())
    groups = THREADS // lanes
    in_flight = max(1, min(ROWS_IN_FLIGHT, -(-n // (groups * sms))))
    return K1Design("rows", word=word, lanes=lanes, in_flight=in_flight,
                    grid=max(1, min(-(-n // (groups * in_flight)), sms * ROWS_BLOCKS_PER_SM)))


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Launch(ctypes.Structure):
    """The C entry's ``K1Launch``: a design's geometry and the host sides."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "design", "word", "lanes", "in_flight", "grid", "src_on_host", "dst_on_host")]


@functools.lru_cache(maxsize=1024)
def _launch_args(design: K1Design, src_on_host: bool, dst_on_host: bool):
    """A ``_Launch`` for this design and its address, kept alive here (a
    sharded transfer repeats the same few geometries launch after launch)."""
    g = _Launch(_DESIGN_CODES[design.design], design.word, design.lanes, design.in_flight,
                design.grid, int(src_on_host), int(dst_on_host))
    return g, ctypes.addressof(g)


def _launch(src: torch.Tensor, dst: torch.Tensor, src_pages: torch.Tensor,
            dst_pages: torch.Tensor, what: str, dev=None, host=(False, False),
            design: K1Design = None, row: int = None) -> bool:
    """One K1 launch over flat ``(pages, payload)`` views of two contiguous
    pools on ``dev`` (default: dst's GPU), or over rows of ``row`` elements
    where it is given; ``host`` marks a side that lies in pinned host
    memory. The design is :func:`k1_design`'s unless one is given. False
    (nothing launched) for an empty table."""
    from repro_torch.kernels import build

    n = int(src_pages.shape[0])
    if n == 0:
        return False
    dev = dst.device if dev is None else dev
    src_pages = src_pages.contiguous()
    dst_pages = dst_pages.contiguous()
    row_bytes = (src.shape[-1] if row is None else row) * src.element_size()
    src_ptr, dst_ptr = src.data_ptr(), dst.data_ptr()
    if design is None:
        design = k1_design(row_bytes, (src_ptr | dst_ptr) & 15, host[0], host[1], n,
                           _multiprocessors(dev.index))
    # the launch is on the hot path of a sharded transfer (a launch a shard
    # pair): a cached geometry, the raw stream handle, and no device switch
    # where dev is current
    _, geometry = _launch_args(design, host[0], host[1])
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with (contextlib.nullcontext() if torch._C._cuda_getDevice() == dev.index
          else torch.cuda.device(dev)):
        err = build.library().kv_transfer_launch(
            src_ptr, dst_ptr, src_pages.data_ptr(), dst_pages.data_ptr(), n, row_bytes,
            geometry, stream)
    build.check(err, what)
    return True


def kv_transfer_design(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                       src_pages: torch.Tensor, dst_pages: torch.Tensor,
                       design: K1Design) -> torch.Tensor:
    """K1 with an explicit design, to time the small-row design beside one
    block a row (``chip_smoke.py``, ``tools/k1_host_ablate.py``) and to test
    each: the routes and checks of :func:`kv_transfer`, one launch counted
    nowhere.
    Returns ``dst_pool``."""
    _transfer(src_pool, dst_pool, src_pages, dst_pages, "kv_transfer_design", design)
    return dst_pool


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
    if _launch(staging.contiguous(), pool, src_pages, dst_pages, "kv_scatter"):
        kv_scatter.launches += 1
    return pool


kv_transfer.launches = 0
kv_transfer.host_launches = 0
kv_transfer_fine.launches = 0
kv_gather.launches = 0
kv_scatter.launches = 0
