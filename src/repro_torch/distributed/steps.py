"""Step functions: train_step / prefill_step / decode_step. Port of
``repro/distributed/steps.py``.

The reference builds each step against a mesh for ``jax.jit``. Here a step
is a plain function on one device; the mesh survives as the ZeRO-1 /
tensor-parallel *specs* of the train state (``zero1_specs``,
``state_spec``), computed over the port's framework-free spec tuples
(``distributed/sharding.py``) from an :class:`AbstractMesh`'s axis sizes.
On one GPU they describe the state and shard nothing.

``train_step`` takes the loss's gradient with respect to the fp32 master
weights through their cast to ``cfg.dtype``, as the reference's does
(``steps.py:76-95``), without its ``with_sharding_constraint`` (which jax
0.9 refuses on an Explicit-axes mesh).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.models.api import Model
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.training import optimizer as OPT


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------
def zero1_specs(params_shapes, p_spec, mesh: SH.AbstractMesh):
    """Extend TP param specs with data(-and-pod)-axis sharding for the
    optimizer state (ZeRO-1): the first unsharded dim divisible by the
    data-axis size additionally shards over ("data",) (+"pod" if present)."""
    sizes = SH.mesh_axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]

    def extend(x, spec):
        parts = list(spec) + [None] * (len(x.shape) - len(spec))
        for i, (dim, cur) in enumerate(zip(x.shape, parts)):
            if cur is None and dim % dp == 0 and dim >= dp:
                parts[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
                break
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    return tree_map(extend, params_shapes, p_spec)


def loss_and_grads(model: Model, master, batch):
    """The loss of ``master`` cast to ``cfg.dtype`` (one cast a leaf, so a
    tied embedding's two uses accumulate into one gradient) and its fp32
    gradient with respect to the fp32 ``master`` leaves, as a tree of
    ``master``'s structure (zeros for a leaf the loss does not read)."""
    leaves = tree_leaves(master)
    for w in leaves:
        w.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = model.loss(tree_map(lambda w: w.to(model.cfg.dtype), master), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for w in leaves:
            w.requires_grad_(False)
    return loss.detach(), tree_unflatten(master, [
        torch.zeros_like(w) if g is None else g for g, w in zip(grads, leaves)])


def make_train_step(model: Model, params_shapes=None,
                    opt_cfg: Optional[OPT.AdamWConfig] = None,
                    compress_pod_grads: bool = False, zero1: bool = True,
                    mesh: Optional[SH.AbstractMesh] = None):
    """Returns (train_step, state_spec).

    ``train_step(state, batch) -> (state, metrics)``: the gradient of
    :func:`loss_and_grads` goes through the optional int8 round trip with
    error feedback (``compress_pod_grads``) into ``OPT.apply_updates``.
    ``metrics`` holds 0-d tensors ``loss``, ``grad_norm`` and ``lr`` on the
    state's device (no host sync).

    ``state_spec``: compute params TP-sharded by the logical rules,
    master / m / v additionally ZeRO-1 sharded over the data(+pod) axes of
    ``mesh`` (default: one device, ``data=1, model=1``).
    """
    opt_cfg = opt_cfg or OPT.AdamWConfig()
    cfg = model.cfg
    mesh = mesh or SH.AbstractMesh(data=1, model=1)
    if params_shapes is None:
        params_shapes = model.init(0, "meta")
    p_spec = SH.tree_specs(params_shapes, model.param_axes(), mesh)
    z_spec = zero1_specs(params_shapes, p_spec, mesh) if zero1 else p_spec

    def train_step(state, batch):
        loss, grads = loss_and_grads(model, state["master"], batch)
        if compress_pod_grads:
            q, scales, residual = OPT.compress_grads(grads, state["ef"])
            grads = OPT.decompress_grads(q, scales)
            new_state, metrics = OPT.apply_updates(
                {k: v for k, v in state.items() if k != "ef"}, grads, opt_cfg,
                compute_dtype=cfg.dtype)
            new_state["ef"] = residual
        else:
            new_state, metrics = OPT.apply_updates(state, grads, opt_cfg,
                                                   compute_dtype=cfg.dtype)
        metrics["loss"] = loss
        return new_state, metrics

    state_spec: Dict[str, Any] = {"params": p_spec, "master": z_spec, "m": z_spec,
                                  "v": z_spec, "step": ()}
    if compress_pod_grads:
        state_spec["ef"] = z_spec
    return train_step, state_spec


def abstract_train_state(model: Model, with_ef: bool = False) -> Dict[str, Any]:
    """The full train state's shapes and dtypes as meta tensors (nothing
    allocated): a template for ``serving/checkpoint.load_train_state``."""
    params = model.init(0, "meta")
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")  # noqa: E731
    state = {
        "params": params,
        "master": tree_map(f32, params),
        "m": tree_map(f32, params),
        "v": tree_map(f32, params),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }
    if with_ef:
        state["ef"] = tree_map(f32, params)
    return state


# ---------------------------------------------------------------------------
# Serve: prefill / decode
# ---------------------------------------------------------------------------
def make_prefill_step(model: Model):
    """prefill_step(params, batch) -> (logits, cache)."""
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model):
    """decode_step(params, token, cache) -> (logits, cache)."""
    def decode_step(params, token, cache):
        return model.decode(params, token, cache)

    return decode_step


# ---------------------------------------------------------------------------
# FlowKV cross-pod KV transfer: the pool the dry-run's transfer cell plans
# ---------------------------------------------------------------------------
def kv_transfer_specs(cfg, mesh: SH.AbstractMesh, seq: int, batch: int):
    """The transfer program's pool as a ``meta`` tensor, and its spec.

    Pool shape (num_blocks, L, 2, payload): block-major (paper Eq. 5), block
    dim sharded over "pod" so each pod owns its page slab. An attention-free
    arch (ssm) transfers its state tensor instead. ``mesh`` is unused, as in
    the reference.
    """
    from repro_torch.core.layout import KVCacheSpec

    del mesh
    n_attn = cfg.num_attention_layers()
    if n_attn == 0:   # ssm: transfer the state tensor instead
        shape = (batch, cfg.num_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        return torch.empty(shape, dtype=cfg.dtype, device="meta"), ("pod",)
    kv_spec = KVCacheSpec(
        num_layers=n_attn,
        num_blocks=batch * -(-seq // cfg.block_size),
        block_size=cfg.block_size,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        dtype=cfg.dtype,
    )
    return torch.empty(kv_spec.shape, dtype=cfg.dtype, device="meta"), ("pod",)
