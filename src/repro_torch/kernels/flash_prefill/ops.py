"""Wrapper of K4, causal GQA flash attention for prefill (cold and suffix).

``flash_prefill_op`` runs the plain version (``ref.flash_prefill_ref``) when
its tensors lie on the CPU, and launches the CUDA kernel
(``csrc/flash_prefill.cu``) when they lie on a GPU — there is no fallback
between the two. The kernel masks its own ragged edges, so nothing is
padded. ``flash_prefill_op.launches`` counts kernel launches,
``flash_prefill_op.suffix_launches`` those of them with ``q_offset > 0`` and
``flash_prefill_op.noncausal_launches`` those with ``causal=False`` (the
enc-dec encoder's bidirectional attention). The kernel has no backward, so
the op refuses inputs that require grad, on every device.

The fp32 kernel takes a launch plan from ``launch_plan``, a pure function of
the shapes and the card's SM count: how many warps (so how many (row, head)
pairs) a block holds, chosen so the grid gives every SM about two blocks.
Its keys are split into runs of ``KEYS_PER_SPLIT`` counted from key 0, one
block each; a tile whose rows span several splits combines them through a
workspace from torch's caching allocator and a zeroed int32 ticket per tile
(``kernels.ticket_counters``, shared with K3) that the kernel leaves zero
again: one launch, no host sync.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_MAX_GROUP = 64
# Keys a split of the fp32 kernel covers (kKeysPerSplit in the source). A
# constant: a row's result is bit-identical across calls only for one split
# length, so it never depends on S, q_offset or the grid.
KEYS_PER_SPLIT = 512
_SM_COUNT: dict = {}            # device index -> streaming multiprocessors


def fp32_pairs_per_warp(hd: int) -> int:
    """(row, head) pairs one warp of the fp32 kernel owns (WP in the source)."""
    return 16 if hd <= 128 else 8


@functools.lru_cache(maxsize=4096)
def launch_plan(b: int, s: int, t: int, h: int, kv: int, hd: int, causal: bool,
                sm_count: int) -> dict:
    """The fp32 kernel's grid for q (b, s, h, hd) over t keys in kv heads.

    ``warps`` a block (4, 2 or 1; 8 at hd 256 when G > 32, so a block holds
    a whole row): the most that still give ``2 * sm_count`` blocks that have
    work, else the fewest. ``pairs`` = warps * WP (row, head) pairs a block,
    ``rows`` query rows a tile, ``tiles`` query tiles per (batch, kv-head),
    ``splits`` runs of KEYS_PER_SPLIT keys, ``blocks`` the blocks with work
    (a tile's causal rows reach only its first splits) and ``grid`` the
    launched blocks. It reads nothing but its arguments: t (with s) sets
    the splits, so it is an argument too.
    """
    g = h // kv
    wp = fp32_pairs_per_warp(hd)
    splits = -(-t // KEYS_PER_SPLIT)
    widest = 4 if 4 * wp >= g else 8
    plans = []
    for nw in (widest, widest // 2, widest // 4):
        if nw < 1 or nw * wp < g:
            continue
        rows = nw * wp // g
        tiles = -(-s // rows)
        if causal:
            off = t - s
            busy = sum(min(splits, (off + min((i + 1) * rows, s) - 1) // KEYS_PER_SPLIT + 1)
                       for i in range(tiles))
        else:
            busy = tiles * splits
        plans.append(dict(warps=nw, pairs=nw * wp, rows=rows, tiles=tiles, splits=splits,
                          blocks=busy * kv * b, grid=tiles * splits * kv * b))
    for plan in plans:
        if plan["blocks"] >= 2 * sm_count:
            return plan
    return plans[-1]


def _sm_count(dev: torch.device) -> int:
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def flash_prefill_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,KV,hd) with ``T == S + q_offset`` -> (B,S,H,hd).

    ``q_offset = 0`` is ordinary causal prefill; ``q_offset > 0`` is SUFFIX
    prefill: the first ``q_offset`` keys are a resident prefix and the
    result is rows ``q_offset..T`` of the full-sequence attention. Raises
    where autograd would record the call (the kernel has no backward).
    """
    from repro_torch.kernels import refuse_autograd

    refuse_autograd("flash_prefill_op", q, k, v)
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
    from repro_torch.kernels import build, ticket_counters

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
        stream = torch.cuda.current_stream(dev)
        nw = nq = ns = 0
        part = tickets = None
        if q.dtype == torch.float32:
            plan = launch_plan(b, s, t, h, kvh, hd, bool(causal), _sm_count(dev))
            nw, nq, ns = plan["warps"], plan["tiles"], plan["splits"]
            if ns > 1:
                part = torch.empty(nq * kvh * b * ns * plan["pairs"] * (hd + 4),
                                   dtype=torch.float32, device=dev)
                tickets = ticket_counters(dev, stream, nq * kvh * b)
        err = build.library().flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kvh, hd, q_offset, int(causal), _DTYPE_CODE[q.dtype], nw, nq, ns,
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), stream.cuda_stream)
    build.check(err, "flash_prefill")
    flash_prefill_op.launches += 1
    if q_offset:
        flash_prefill_op.suffix_launches += 1
    if not causal:
        flash_prefill_op.noncausal_launches += 1
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned (the kernel loads 16-byte vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


flash_prefill_op.launches = 0
flash_prefill_op.suffix_launches = 0
flash_prefill_op.noncausal_launches = 0
