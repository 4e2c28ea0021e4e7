"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel.

Each kernel ships three pieces: CUDA C++ source under ``repro_torch/csrc``
(built with ``nvcc`` by ``build.py`` on first use), a wrapper in
``<name>/ops.py`` that runs the plain version on CPU tensors and launches
the kernel on CUDA tensors (never falling back), and the plain PyTorch
version in ``<name>/ref.py``. Each wrapper counts its launches in a
``launches`` attribute.

Ported: K1 ``kv_gather/ops.kv_transfer`` (with K2, the fused decode append
``kv_gather/kv_append``) and K3 ``paged_attention/ops.paged_decode_attention``.
"""
from __future__ import annotations


def launch_counts() -> dict:
    """Kernel launches counted by every wrapper since the last reset."""
    from repro_torch.kernels.kv_gather.ops import kv_transfer
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    return {"kv_transfer": kv_transfer.launches,
            "paged_decode_attention": paged_decode_attention.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels.kv_gather.ops import kv_transfer
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    kv_transfer.launches = 0
    paged_decode_attention.launches = 0
