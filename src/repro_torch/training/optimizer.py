"""AdamW with mixed-precision master weights, plus optional int8 gradient
compression with error feedback. Port of ``repro/training/optimizer.py``.

Train state layout (dicts parallel to params):

    params  — compute copy, model dtype (bf16 on the big configs)
    master  — fp32 master weights
    m, v    — fp32 Adam moments
    step    — int32 0-d tensor

The arithmetic is the reference's, op for op, and not
``torch.optim.AdamW``'s: the warm-up reads the incremented step plus one,
the bias corrections ``1 - b ** step`` are computed in fp32, weight decay
applies to every leaf, and the clip scale is
``min(1, clip / (gnorm + 1e-9))``. Every scalar of the update (lr, the clip
scale, the bias corrections) stays a 0-d tensor on the state's device, so a
step never waits for the host.

``compress_grads`` / ``decompress_grads`` implement per-tensor symmetric
int8 quantization with an error-feedback accumulator; ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

Tensor = torch.Tensor


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_state(params) -> Dict[str, Any]:
    zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {
        "params": params,
        "master": tree_map(lambda p: p.float().clone(), params),
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    }


def _lr_at(cfg: AdamWConfig, step: Tensor) -> Tensor:
    warm = torch.clamp((step + 1).float() / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(state: Dict[str, Any], grads, cfg: AdamWConfig,
                  compute_dtype=None) -> Tuple[Dict[str, Any], Dict[str, Tensor]]:
    """One AdamW step. Returns (new_state, metrics).

    The state's ``m``, ``v`` and ``master`` tensors are updated in place (the
    reference donates the state to its jitted step) and the new state holds
    them; ``params`` are new tensors, cast from the updated masters.
    """
    step = state["step"] + 1
    lr = _lr_at(cfg, step)
    gnorm = global_norm(grads)
    # a tensor numerator: python_float / tensor multiplies by a reciprocal
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    f32 = step.float()
    bc1 = 1.0 - torch.pow(torch.full_like(f32, b1), f32)
    bc2 = 1.0 - torch.pow(torch.full_like(f32, b2), f32)

    def upd(g, m, v, w):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        w.sub_(lr * u.add_(cfg.weight_decay * w))

    for g, m, v, w in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(state["master"])):
        upd(g, m, v, w)
    params = tree_map(lambda w, p: w.to(compute_dtype or p.dtype), state["master"],
                      state["params"])
    new_state = {"params": params, "master": state["master"], "m": state["m"],
                 "v": state["v"], "step": step}
    return new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------
def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_grads(grads, residual):
    """Per-tensor symmetric int8 quantization; returns (q, scales, new_residual)."""
    def one(g, r):
        g = g.float() + r
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q, scale, g - q.float() * scale

    out = tree_map(one, grads, residual)
    return _pick(out, 0), _pick(out, 1), _pick(out, 2)


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def decompress_grads(q, scales):
    return tree_map(lambda qq, s: qq.float() * s, q, scales)
