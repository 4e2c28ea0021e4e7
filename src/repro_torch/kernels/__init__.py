"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel.

Each kernel ships three pieces: CUDA C++ source under ``repro_torch/csrc``
(built with ``nvcc`` by ``build.py`` on first use), a wrapper in
``<name>/ops.py`` that runs the plain version on CPU tensors and launches
the kernel on CUDA tensors (never falling back), and the plain PyTorch
version in ``<name>/ref.py``. Each wrapper counts its launches in a
``launches`` attribute.

Ported, every TPU kernel of the reference: K1 ``kv_gather/ops.kv_transfer``
(with K2, the fused decode append ``kv_gather/kv_append``, and
``kv_gather/ops.kv_transfer_fine``, its launch over one shard pair's fine
rows), K3
``paged_attention/ops.paged_decode_attention``, K4
``flash_prefill/ops.flash_prefill_op``, and K5a/K5b
``kv_gather/ops.kv_gather`` (its own block copy) / ``kv_scatter`` (which
launches K1's kernel).
"""
from __future__ import annotations

_TICKETS: dict = {}             # (device index, stream) -> zeroed int32 tickets


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel call: K3 and K4 have no
    backward, and a CUDA kernel's output has no ``grad_fn``, so a gradient
    through them would be lost without an error on the card (on the CPU
    the plain version would differentiate). Checked on every device, so a
    CPU test catches a training path that reaches a kernel."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no backward; "
            "training attention takes the chunked models/flash.py "
            "(self_attention(..., train=True))")


def ticket_counters(dev, stream, n: int):
    """Zeroed int32 tickets, at least ``n``, for the kernels whose blocks
    elect the last of a group by an atomic ticket (K3, K4 fp32): one buffer
    per (device, stream). Each kernel leaves the tickets it used at zero
    again, so the calls that share a buffer are ordered on its stream."""
    import torch

    key = (dev.index, stream.cuda_stream)
    c = _TICKETS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 2 * (0 if c is None else c.numel())), dtype=torch.int32,
                        device=dev)
        _TICKETS[key] = c
    return c


def _wrappers() -> dict:
    from repro_torch.kernels.flash_prefill.ops import flash_prefill_op
    from repro_torch.kernels.kv_gather.ops import (kv_gather, kv_scatter, kv_transfer,
                                                   kv_transfer_fine)
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    return {"kv_transfer": kv_transfer, "kv_transfer_fine": kv_transfer_fine,
            "paged_decode_attention": paged_decode_attention,
            "flash_prefill": flash_prefill_op, "kv_gather": kv_gather,
            "kv_scatter": kv_scatter}


def launch_counts() -> dict:
    """Kernel launches counted by every wrapper since the last reset, plus
    ``flash_prefill_suffix`` (the K4 launches in suffix mode),
    ``flash_prefill_noncausal`` (those with ``causal=False``) and
    ``kv_transfer_host`` (K1's launches with a pinned host pool);
    ``kv_transfer_fine`` counts K1's launches over a sharded plan's fine
    rows."""
    w = _wrappers()
    counts = {name: fn.launches for name, fn in w.items()}
    counts["flash_prefill_suffix"] = w["flash_prefill"].suffix_launches
    counts["flash_prefill_noncausal"] = w["flash_prefill"].noncausal_launches
    counts["kv_transfer_host"] = w["kv_transfer"].host_launches
    return counts


def reset_launch_counts() -> None:
    w = _wrappers()
    for fn in w.values():
        fn.launches = 0
    w["flash_prefill"].suffix_launches = 0
    w["flash_prefill"].noncausal_launches = 0
    w["kv_transfer"].host_launches = 0
