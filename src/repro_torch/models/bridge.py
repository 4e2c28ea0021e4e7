"""Weight bridge from the reference package's param tree to the port's.

``jax.random`` cannot be reproduced in torch, so parity tests initialize
the reference model, turn its param tree into numpy (the caller does that;
this module imports no JAX) and bridge it here: same names, same shapes,
same dtype. A bfloat16 leaf — an ``ml_dtypes`` array that
``torch.from_numpy`` refuses — crosses as its ``uint16`` bit pattern and
is re-viewed as ``torch.bfloat16``, so the bridge is bit-exact.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig

# Leaves the reference keeps in float32 whatever cfg.dtype is: mamba2's
# A_log / dt_bias and the RG-LRU's lam / b_a / b_i.
FP32_LEAVES = frozenset({"A_log", "dt_bias", "lam", "b_a", "b_i"})


def to_torch(arr: np.ndarray, device=None) -> torch.Tensor:
    """One numpy leaf -> tensor, bit-exact (bfloat16 via a uint16 view)."""
    arr = np.array(arr)                  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy; bfloat16 comes back as float32 (exact widening)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def from_reference(params_np: Dict[str, Any], cfg: ModelConfig,
                   device=None) -> Dict[str, Any]:
    """Bridge a numpy copy of the reference's params to the port's tensors.

    ``params_np`` has the reference's structure, any nesting of dicts: the
    transformer's ``embed`` / ``final_norm`` / ``layers`` -> {name: (L, ...)},
    griffin's stacked ``groups`` and unrolled ``tail_*``, enc-dec's
    ``encoder`` / ``decoder`` stacks. Leaves keep their names, shapes and
    dtypes: a floating leaf must be ``cfg.dtype``, or float32 where the
    reference keeps it so (:data:`FP32_LEAVES`).
    """
    dev = resolve_device(device)

    def conv(tree, name=""):
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        t = to_torch(tree, dev)
        want = torch.float32 if name in FP32_LEAVES else cfg.dtype
        if t.is_floating_point() and t.dtype != want:
            raise TypeError(f"param {name!r} dtype {t.dtype} != {want}")
        return t

    return conv(params_np)


def train_state_from_reference(state_np: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Bridge a numpy copy of the reference's train state (``params``,
    ``master``, ``m``, ``v``, ``step``, optional ``ef``; see
    ``training/optimizer.init_state``) leaf for leaf, bit-exact, each in
    its own dtype (after a step every ``params`` leaf is ``cfg.dtype``)."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return to_torch(tree, dev)

    return conv(state_np)
