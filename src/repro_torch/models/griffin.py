"""Griffin / RecurrentGemma (arXiv:2402.19427): RG-LRU recurrent blocks and
local (sliding-window) MQA attention in a repeating (rec, rec, attn)
pattern. Port of ``repro/models/griffin.py``.

RG-LRU gate math (c = 8)::

    r_t = sigmoid(x_t W_a + b_a)          # recurrence gate
    i_t = sigmoid(x_t W_i + b_i)          # input gate
    log a_t = -c * softplus(-Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill evaluates the linear recurrence with a log-depth (Hillis-Steele)
scan over the sequence, ceil(log2 S) rounds of elementwise ops, where the
reference calls ``jax.lax.associative_scan``; the two sum in a different
order, so they agree within fp32 rounding, not bit for bit. Decode is the
O(1) update. Local-attention layers keep a ring buffer of ``attn_window``
slots (slot ``q % W`` holds position q).

Params keep the reference's layout: one (rec, mlp, rec, mlp, attn, mlp)
group stacked on a leading ``groups`` axis, and the layers past the last
whole group unrolled as ``tail_rec{t}`` / ``tail_mlp{t}``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as MLPM
from repro_torch.models.common import (ModelConfig, dense_init, embed, make_generator,
                                       maybe_remat, rms_norm, softmax_cross_entropy,
                                       unbind_layers, unembed)
from repro_torch.models.mamba2 import softplus
from repro_torch.models.transformer import _head

Params = Dict[str, Any]
Tensor = torch.Tensor
_C = 8.0   # RG-LRU gate sharpness constant


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _rec_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "norm": (d,), "w_gate": (d, w), "w_branch": (d, w), "conv": (4, w),
        "w_a": (w, w), "b_a": (w,), "w_i": (w, w), "b_i": (w,),
        "lam": (w,), "w_out": (w, d),
    }


def _rec_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "norm": ("embed",), "w_gate": ("embed", "lru"), "w_branch": ("embed", "lru"),
        "conv": ("conv", "lru"), "w_a": ("lru_in", "lru"), "b_a": ("lru",),
        "w_i": ("lru_in", "lru"), "b_i": ("lru",), "lam": ("lru",),
        "w_out": ("lru", "embed"),
    }


def _mlp_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    return {"norm": (cfg.d_model,), **MLPM.mlp_param_shapes(cfg)}


def _mlp_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {"norm": ("embed",), **MLPM.mlp_param_axes()}


def _attn_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    return {"norm": (cfg.d_model,), **A.attn_param_shapes(cfg)}


def _attn_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    return {"norm": ("embed",), **A.attn_param_axes(cfg)}


def _init_block(gen: torch.Generator, shapes: Dict[str, Tuple[int, ...]],
                cfg: ModelConfig, stack: int = 0) -> Params:
    out = {}
    dev = torch.device("meta") if gen is None else gen.device
    for name, shape in shapes.items():
        full = (stack, *shape) if stack else shape
        if name == "lam":
            # a = sigmoid(lam)^(c*r) then lies in ~(0.9, 0.999)
            out[name] = torch.full(full, 4.0, dtype=torch.float32, device=dev)
        elif name.startswith("b_"):
            out[name] = torch.zeros(full, dtype=torch.float32, device=dev)
        elif name.startswith("norm"):
            out[name] = torch.zeros(full, dtype=cfg.dtype, device=dev)
        else:
            out[name] = dense_init(gen, full, cfg.dtype)
    return out


def num_groups_and_tail(cfg: ModelConfig) -> Tuple[int, int]:
    plen = len(cfg.layer_pattern)
    return cfg.num_layers // plen, cfg.num_layers % plen


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random params from a ``torch.Generator`` seeded with ``seed``, in the
    reference's layout (tests bridge the reference's own init instead)."""
    assert cfg.layer_pattern == ("rec", "rec", "attn"), "griffin pattern fixed"
    dev = resolve_device(device)
    gen = make_generator(dev, seed)
    G, tail = num_groups_and_tail(cfg)
    group = {
        "rec0": _init_block(gen, _rec_shapes(cfg), cfg, stack=G),
        "mlp0": _init_block(gen, _mlp_shapes(cfg), cfg, stack=G),
        "rec1": _init_block(gen, _rec_shapes(cfg), cfg, stack=G),
        "mlp1": _init_block(gen, _mlp_shapes(cfg), cfg, stack=G),
        "attn": _init_block(gen, _attn_shapes(cfg), cfg, stack=G),
        "mlp2": _init_block(gen, _mlp_shapes(cfg), cfg, stack=G),
    }
    params: Params = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype, 0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=dev),
        "groups": group,
    }
    for t in range(tail):   # tail layers are always "rec" for 26 = 8*3 + 2
        params[f"tail_rec{t}"] = _init_block(gen, _rec_shapes(cfg), cfg)
        params[f"tail_mlp{t}"] = _init_block(gen, _mlp_shapes(cfg), cfg)
    return params


def param_axes(cfg: ModelConfig) -> Params:
    G, tail = num_groups_and_tail(cfg)

    def stack_axes(ax):
        return {k: ("groups", *v) for k, v in ax.items()}

    axes: Params = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "groups": {
            "rec0": stack_axes(_rec_axes()), "mlp0": stack_axes(_mlp_axes()),
            "rec1": stack_axes(_rec_axes()), "mlp1": stack_axes(_mlp_axes()),
            "attn": stack_axes(_attn_axes(cfg)), "mlp2": stack_axes(_mlp_axes()),
        },
    }
    for t in range(tail):
        axes[f"tail_rec{t}"] = _rec_axes()
        axes[f"tail_mlp{t}"] = _mlp_axes()
    return axes


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def linear_scan(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (h_{-1} = 0) over dim 1.

    Returns (prod_{s<=t} a_s, h_t). Hillis-Steele: round k combines each
    element with the one 2^k before it, ``(a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2)``, so ceil(log2 S) rounds of elementwise ops.
    """
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return a, b


def _rg_lru(bx: Tensor, p: Params, h0: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """bx (B,S,W) -> (out (B,S,W) in bx's dtype, h_final (B,W) fp32)."""
    r = torch.sigmoid(torch.matmul(bx, p["w_a"]).float() + p["b_a"][None, None])
    i = torch.sigmoid(torch.matmul(bx, p["w_i"]).float() + p["b_i"][None, None])
    log_a = (-_C * softplus(-p["lam"].float()))[None, None] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * bx.float()
    if bx.shape[1] == 1:   # decode fast path
        h = gated[:, 0] if h0 is None else a[:, 0] * h0 + gated[:, 0]
        return h[:, None].to(bx.dtype), h
    a_scan, h_scan = linear_scan(a, gated)
    if h0 is not None:
        h_scan = h_scan + a_scan * h0[:, None]
    return h_scan.to(bx.dtype), h_scan[:, -1]


def _rec_block(cfg: ModelConfig, p: Params, x: Tensor, conv_state=None,
               h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (out, new_conv_state, h_final)."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    gate = F.gelu(torch.matmul(xn, p["w_gate"]), approximate="tanh")
    bx = torch.matmul(xn, p["w_branch"])
    # causal depthwise conv (window 4), no activation (griffin's plain conv)
    cw = p["conv"].shape[0]
    if conv_state is None:
        conv_state = bx.new_zeros((x.shape[0], cw - 1, bx.shape[-1]))
    xx = torch.cat([conv_state.to(bx.dtype), bx], dim=1)
    bx = sum(xx[:, i:i + bx.shape[1]] * p["conv"][i][None, None] for i in range(cw))
    new_conv = xx[:, -(cw - 1):]
    lru_out, h_final = _rg_lru(bx, p, h0)
    out = torch.matmul(lru_out * gate, p["w_out"])
    return x + out, new_conv, h_final


def _mlp_block(cfg: ModelConfig, p: Params, x: Tensor) -> Tensor:
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    return x + MLPM.gated_mlp(p, xn, "gelu")


def _attn_block_train(cfg: ModelConfig, p: Params, x: Tensor, positions: Tensor,
                      train: bool = False) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    out, (k, v) = A.self_attention(p, xn, cfg, positions, window=cfg.attn_window,
                                   train=train)
    return x + out, (k, v)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def _group(params: Params, g: int) -> Params:
    return {blk: {k: v[g] for k, v in leaves.items()}
            for blk, leaves in params["groups"].items()}


def _scan_groups(cfg: ModelConfig, params: Params, x: Tensor, positions: Tensor):
    """Every whole (rec, rec, attn) group in turn; returns (x, per-group
    (conv0, h0, conv1, h1, k, v) stacked on a leading groups axis)."""
    outs = []
    for g in range(num_groups_and_tail(cfg)[0]):
        gp = _group(params, g)
        x, conv0, hf0 = _rec_block(cfg, gp["rec0"], x)
        x = _mlp_block(cfg, gp["mlp0"], x)
        x, conv1, hf1 = _rec_block(cfg, gp["rec1"], x)
        x = _mlp_block(cfg, gp["mlp1"], x)
        x, (k, v) = _attn_block_train(cfg, gp["attn"], x, positions)
        x = _mlp_block(cfg, gp["mlp2"], x)
        outs.append((conv0, hf0, conv1, hf1, k, v))
    return x, tuple(torch.stack(t) for t in zip(*outs))


def _group_train(cfg: ModelConfig, positions: Tensor, x: Tensor, gp: Params) -> Tensor:
    """One whole (rec, mlp, rec, mlp, attn, mlp) group, training flavour."""
    x = _mlp_block(cfg, gp["mlp0"], _rec_block(cfg, gp["rec0"], x)[0])
    x = _mlp_block(cfg, gp["mlp1"], _rec_block(cfg, gp["rec1"], x)[0])
    x, _ = _attn_block_train(cfg, gp["attn"], x, positions, train=True)
    return _mlp_block(cfg, gp["mlp2"], x)


def forward_train(params: Params, cfg: ModelConfig, tokens: Tensor,
                  frontend_embeds=None) -> Tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, aux_loss = 0): the whole
    groups, each one ``maybe_remat`` call, then the "rec" tail layers."""
    x = embed(tokens, params["embed"], cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = maybe_remat(functools.partial(_group_train, cfg, positions), cfg)
    blocks = {blk: unbind_layers(leaves) for blk, leaves in params["groups"].items()}
    for g in range(num_groups_and_tail(cfg)[0]):
        x = body(x, {blk: per_group[g] for blk, per_group in blocks.items()})
    for t in range(num_groups_and_tail(cfg)[1]):
        x = _rec_block(cfg, params[f"tail_rec{t}"], x)[0]
        x = _mlp_block(cfg, params[f"tail_mlp{t}"], x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"]), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]) -> Tensor:
    logits, _ = forward_train(params, cfg, batch["tokens"])
    mask = batch.get("loss_mask")
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                                 None if mask is None else mask[:, 1:])


def _ring_from_prefill(k: Tensor, window: int) -> Tensor:
    """k (..., S, KV, hd) -> ring (..., W, KV, hd) with slot q%W = roped k[q]."""
    s = k.shape[-3]
    w = window
    ring = k.new_zeros((*k.shape[:-3], w, *k.shape[-2:]))
    if s >= w:
        slots = torch.arange(s - w, s, device=k.device) % w
        ring[..., slots, :, :] = k[..., s - w:, :, :]
    else:
        ring[..., :s, :, :] = k
    return ring


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor,
            frontend_embeds=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Last-position logits (B, V) fp32 and the request state: the rec
    layers' conv tails and fp32 h, the attention layers' rings, length."""
    x = embed(tokens, params["embed"], cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, (conv0, hf0, conv1, hf1, ks, vs) = _scan_groups(cfg, params, x, positions)
    cache: Dict[str, Tensor] = {
        "g_conv0": conv0, "g_h0": hf0, "g_conv1": conv1, "g_h1": hf1,
        "g_k": _ring_from_prefill(ks, cfg.attn_window),
        "g_v": _ring_from_prefill(vs, cfg.attn_window),
    }
    for t in range(num_groups_and_tail(cfg)[1]):
        x, conv, hf = _rec_block(cfg, params[f"tail_rec{t}"], x)
        x = _mlp_block(cfg, params[f"tail_mlp{t}"], x)
        cache[f"t_conv{t}"] = conv
        cache[f"t_h{t}"] = hf
    cache["length"] = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                                 device=x.device)
    return _head(params, cfg, x[:, -1:]), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, dtype=None,
               device=None) -> Dict[str, Tensor]:
    del max_len   # bounded by window / state size
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    G, tail = num_groups_and_tail(cfg)
    w, lru, cw = cfg.attn_window, cfg.lru_width, 4

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache = {
        "g_conv0": z((G, batch, cw - 1, lru)),
        "g_h0": z((G, batch, lru), torch.float32),
        "g_conv1": z((G, batch, cw - 1, lru)),
        "g_h1": z((G, batch, lru), torch.float32),
        "g_k": z((G, batch, w, cfg.num_kv_heads, cfg.head_dim)),
        "g_v": z((G, batch, w, cfg.num_kv_heads, cfg.head_dim)),
        "length": z((batch,), torch.int32),
    }
    for t in range(tail):
        cache[f"t_conv{t}"] = z((batch, cw - 1, lru))
        cache[f"t_h{t}"] = z((batch, lru), torch.float32)
    return cache


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    _, tail = num_groups_and_tail(cfg)
    axes = {
        "g_conv0": ("groups", "batch", "conv", "lru"),
        "g_h0": ("groups", "batch", "lru"),
        "g_conv1": ("groups", "batch", "conv", "lru"),
        "g_h1": ("groups", "batch", "lru"),
        "g_k": ("groups", "batch", "kv_seq", "kv_heads", "head_dim"),
        "g_v": ("groups", "batch", "kv_seq", "kv_heads", "head_dim"),
        "length": ("batch",),
    }
    for t in range(tail):
        axes[f"t_conv{t}"] = ("batch", "conv", "lru")
        axes[f"t_h{t}"] = ("batch", "lru")
    return axes


def _ring_decode_attn(cfg: ModelConfig, p: Params, x: Tensor, ring_k: Tensor,
                      ring_v: Tensor, pos: Tensor) -> Tensor:
    """One-token local attention over a ring buffer of W slots.

    x (B,1,D); ring_k/v (B,W,KV,hd), written IN PLACE at slot ``pos % W``;
    pos (B,) absolute position of the new token. Slot s holds absolute
    position q = pos - ((pos - s) mod W); slots never written are masked.
    """
    w = ring_k.shape[1]
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k_new, v_new = A.qkv_project(p, xn, cfg, pos[:, None])
    slot = (pos % w).long()
    b_idx = torch.arange(x.shape[0], device=x.device)
    ring_k[b_idx, slot] = k_new[:, 0].to(ring_k.dtype)
    ring_v[b_idx, slot] = v_new[:, 0].to(ring_v.dtype)
    s_idx = torch.arange(w, device=x.device)[None, :]
    qpos = pos[:, None].long()
    slot_pos = qpos - torch.remainder(qpos - s_idx, w)
    mask = (slot_pos >= 0)[:, None, None, None, :]
    out = A.attend(q, ring_k, ring_v, mask)
    return x + A.out_project(p, out)


def decode_step(params: Params, cfg: ModelConfig, token: Tensor,
                cache: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """token (B,) int; returns (logits (B, V) fp32, a new cache; the input
    cache is not modified)."""
    x = embed(token[:, None], params["embed"], cfg.embed_scale)
    pos = cache["length"]
    G, tail = num_groups_and_tail(cfg)
    rk, rv = cache["g_k"].clone(), cache["g_v"].clone()
    outs = []
    for g in range(G):
        gp = _group(params, g)
        x, c0, h0 = _rec_block(cfg, gp["rec0"], x, conv_state=cache["g_conv0"][g],
                               h0=cache["g_h0"][g])
        x = _mlp_block(cfg, gp["mlp0"], x)
        x, c1, h1 = _rec_block(cfg, gp["rec1"], x, conv_state=cache["g_conv1"][g],
                               h0=cache["g_h1"][g])
        x = _mlp_block(cfg, gp["mlp1"], x)
        x = _ring_decode_attn(cfg, gp["attn"], x, rk[g], rv[g], pos)
        x = _mlp_block(cfg, gp["mlp2"], x)
        outs.append((c0, h0, c1, h1))
    c0, h0, c1, h1 = (torch.stack(t) for t in zip(*outs))
    new_cache = {"g_conv0": c0, "g_h0": h0, "g_conv1": c1, "g_h1": h1,
                 "g_k": rk, "g_v": rv}
    for t in range(tail):
        x, conv, hf = _rec_block(cfg, params[f"tail_rec{t}"], x,
                                 conv_state=cache[f"t_conv{t}"], h0=cache[f"t_h{t}"])
        x = _mlp_block(cfg, params[f"tail_mlp{t}"], x)
        new_cache[f"t_conv{t}"] = conv
        new_cache[f"t_h{t}"] = hf
    new_cache["length"] = cache["length"] + 1
    return _head(params, cfg, x), new_cache
