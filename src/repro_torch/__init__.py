"""PyTorch / CUDA port of the FlowKV reproduction (reference: ``repro``).

Same subpackage layout and module names as the JAX package, so every file
names its reference by the same relative path. The port imports torch,
numpy and the standard library only — never JAX, never ``repro``.

Entry points take a ``device``: the default is ``"cuda"``, and asking for
CUDA on a machine without a GPU raises instead of quietly running on the
CPU (:func:`resolve_device`). Tests pass ``device="cpu"``.

Kernels (``repro_torch/kernels``) are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` on first use; on CPU tensors their
wrappers run the plain PyTorch versions.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means CUDA, and CUDA must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
