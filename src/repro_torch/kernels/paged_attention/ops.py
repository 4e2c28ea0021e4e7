"""Wrapper of K3, the paged decode attention over the FlowKV pool.

``paged_decode_attention`` takes the WHOLE pool ``(nb, L, 2, payload)`` and
a layer index. On CPU tensors it runs the plain version
(``ref.paged_decode_attention_stats_ref`` on the view ``pool[:, layer]``);
on GPU tensors it launches the CUDA kernel (``csrc/paged_attention.cu``),
which reads the layer through the pool's strides — there is no fallback
between the two. ``paged_decode_attention.launches`` counts kernel launches.
The kernel has no backward, so the op refuses inputs that require grad, on
every device.

The kernel splits each row's pages into runs of ``PAGES_PER_SPLIT`` pages
counted from page 0, one block per (row, kv-head, split), sized from the
table width; the last block of a (row, kv-head) combines the partials. Its
partials live in a workspace from torch's caching allocator, and its
tickets in a zeroed int32 counter per (device, stream) that the kernel
leaves zero again: one launch, no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ref import paged_decode_attention_stats_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 16
_MAX_HEAD_DIM = 256
# Pages a split of the CUDA kernel covers (4 pages = 128 tokens at block 32;
# PERF.md has the times of 2 and 8, from tools/k3_ablate.py). A constant: a
# row's result is bit-identical across batches only for one split length.
PAGES_PER_SPLIT = 4


def paged_decode_attention(q: torch.Tensor, pool: torch.Tensor, layer: int,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           *, block_size: int, return_stats: bool = False):
    """q (B,H,hd); pool (nb, L, 2, payload); block_tables (B, W) int32;
    lengths (B,) int32.

    Returns ``out (B,H,hd)``; with ``return_stats`` also the fp32
    online-softmax max ``m`` and normalizer ``l`` per (B, KV, G). Raises
    where autograd would record the call (the kernel has no backward).
    """
    from repro_torch.kernels import refuse_autograd

    refuse_autograd("paged_decode_attention", q, pool)
    b, h, hd = q.shape
    nb, L, two, payload = pool.shape
    if two != 2 or payload % (block_size * hd):
        raise ValueError(f"pool {tuple(pool.shape)} is not a FlowKV pool of "
                         f"block_size={block_size}, head_dim={hd}")
    kv = payload // (block_size * hd)
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv-heads")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    dev = pool.device
    if dev.type == "cpu":
        out, m, l = paged_decode_attention_stats_ref(
            q, pool[:, layer], block_tables, lengths, block_size)
        return (out, m, l) if return_stats else out
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {dev}")
    from repro_torch.kernels import build, ticket_counters

    g = h // kv
    if q.dtype != pool.dtype or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/pool dtypes {q.dtype}/{pool.dtype}: the kernel takes "
                        "float32 or bfloat16, the same for both")
    if g > _MAX_GROUP or hd > _MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"kernel supports G <= {_MAX_GROUP} and hd <= {_MAX_HEAD_DIM}, "
                         f"a multiple of 8; got G={g}, hd={hd}")
    for name, t in (("q", q), ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, pool on {dev}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if not pool.is_contiguous() or pool.data_ptr() % 16:
        raise ValueError("the pool must be contiguous and 16-byte aligned (the kernel "
                         "computes page addresses from its layout)")
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    m = torch.empty((b, kv, g), dtype=torch.float32, device=dev)
    l = torch.empty((b, kv, g), dtype=torch.float32, device=dev)
    w = block_tables.shape[1]
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        part = torch.empty(lib.paged_decode_attention_workspace_floats(
            b, h, kv, hd, w, PAGES_PER_SPLIT), dtype=torch.float32, device=dev)
        tickets = ticket_counters(dev, stream, b * kv)
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), pool.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), b, h, kv, hd, block_size, L, layer, w,
            PAGES_PER_SPLIT, _DTYPE_CODE[q.dtype], stream.cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return (out, m, l) if return_stats else out


paged_decode_attention.launches = 0
