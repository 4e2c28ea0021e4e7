"""Granite 4.0-H (``granitemoehybrid``): Mamba-2 and NoPE attention layers,
each followed by a routed MoE beside a shared expert, with Granite's
multipliers. Its layer equations (hf:ibm-granite/granite-4.0-h-small)::

    x = embed(tokens) * embed_multiplier
    x = x + residual_multiplier * mixer(RMSNorm(x))   # Mamba-2 or attention
    y = RMSNorm(x)
    x = x + residual_multiplier * (moe_share(y) + shared(y))
    logits = unembed(RMSNorm(x)) / logits_scaling

The Mamba-2 mixer is ``models/mamba2.py``'s (one group of B and C, the
causal conv with a bias, SSD in chunks of ``ssm_chunk``, the gated RMSNorm
before the out projection) without its own norm and residual; its SSD
runs every chunk of a prefill chunk at once (:func:`ssd_chunks`, the
arithmetic of ``mamba2._ssd_chunked``'s loop). Attention is
``models/attention.py``'s: no RoPE (``use_rope=False``) and the score scale
``attn_scale`` folded into q, so the plain path, K4, K5a/K5b and K3 serve it
unchanged. The MoE is ``models/moe.py``'s expert share
(:func:`~repro_torch.models.moe.moe_share_ffn`): the router keeps all
``num_experts`` outputs and its top-k, and the ``moe_experts_held`` experts
held here (experts 0 .. held - 1) give their part of the result, by the
dense dispatch (static shapes for the decode graphs, prefill chunks alike).

Params: ``layers`` holds what every layer has (norms, router, held
experts, shared expert) stacked over all layers; ``mamba`` and ``attn``
hold each mixer's leaves stacked over the layers of that kind, in order.

Serving keeps the attention layers' K/V in the paged pool and a request's
Mamba-2 state in a slot of ``serving/state_slots.py``: :func:`prefill_chunk`
runs one prefill chunk from the carried state and the pool's prefix K/V;
:func:`decode_step_paged` runs one batched step over the pool (K3 a layer,
one K1 append) and the slots (read and written in place by slot id).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models.common import (ModelConfig, dense_init, make_generator, rms_norm,
                                       softmax_cross_entropy, unembed)
from repro_torch.models.mamba2 import _causal_conv, softplus

Params = Dict[str, Any]
Tensor = torch.Tensor


def mixer_index(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Each layer's mixer kind and its index in that kind's stack."""
    seen = {"mamba": 0, "attn": 0}
    out = []
    for kind in cfg.layer_kinds():
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def conv_width(cfg: ModelConfig) -> int:
    """Channels of the causal conv: x, B and C side by side."""
    return cfg.ssm_d_inner + 2 * cfg.ssm_state


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def param_shapes(cfg: ModelConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Every stacked leaf's shape, by group (``layers``, ``mamba``, ``attn``)."""
    kinds = cfg.layer_kinds()
    L, Lm, La = cfg.num_layers, kinds.count("mamba"), kinds.count("attn")
    d, di, n, h, cw = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    e, f, fs = cfg.experts_held, cfg.moe_d_ff, cfg.shared_d_ff
    layers = {"norm_mixer": (L, d), "norm_ffn": (L, d), "moe_router": (L, d, cfg.num_experts),
              "moe_w_gate": (L, e, d, f), "moe_w_up": (L, e, d, f),
              "moe_w_down": (L, e, f, d), "shared_w_gate": (L, d, fs),
              "shared_w_up": (L, d, fs), "shared_w_down": (L, fs, d)}
    mamba = {"w_z": (Lm, d, di), "w_x": (Lm, d, di), "w_B": (Lm, d, n), "w_C": (Lm, d, n),
             "w_dt": (Lm, d, h), "conv_x": (Lm, cw, di), "conv_B": (Lm, cw, n),
             "conv_C": (Lm, cw, n), "A_log": (Lm, h), "D": (Lm, h), "dt_bias": (Lm, h),
             "norm": (Lm, di), "w_out": (Lm, di, d)}
    if cfg.ssm_conv_bias:
        mamba.update(conv_bias_x=(Lm, di), conv_bias_B=(Lm, n), conv_bias_C=(Lm, n))
    hd = cfg.head_dim
    attn = {"wq": (La, d, cfg.num_heads, hd), "wk": (La, d, cfg.num_kv_heads, hd),
            "wv": (La, d, cfg.num_kv_heads, hd), "wo": (La, cfg.num_heads, hd, d)}
    return {"layers": layers, "mamba": mamba, "attn": attn}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random params from a ``torch.Generator``: matrices at their true
    fan-in (``wq`` ``d``, ``wo`` ``H hd``), the embedding 0.02, norm gains
    0, and Mamba-2's own initialisation: conv taps and biases uniform in
    +-``ssm_conv ** -0.5``, ``A_log`` log(1..H), ``D`` 1, ``dt_bias`` the
    inverse softplus of dt = exp(U(log 0.001, log 0.1))."""
    dev = resolve_device(device)
    gen = make_generator(dev, seed)
    shapes = param_shapes(cfg)
    zeros = lambda s, dt=cfg.dtype: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    layers = {}
    for name, s in shapes["layers"].items():
        layers[name] = zeros(s) if name.startswith("norm") else dense_init(gen, s, cfg.dtype)
    mamba = {}
    for name, s in shapes["mamba"].items():
        if name == "A_log":
            mamba[name] = torch.log(torch.arange(1, s[1] + 1, dtype=torch.float32,
                                                 device=dev)).expand(s).contiguous()
        elif name == "dt_bias":
            dt = torch.exp(torch.empty(s, device=dev).uniform_(
                math.log(0.001), math.log(0.1), generator=gen))
            mamba[name] = dt + torch.log(-torch.expm1(-dt))
        elif name == "D":
            mamba[name] = torch.ones(s, dtype=cfg.dtype, device=dev)
        elif name == "norm":
            mamba[name] = zeros(s)
        elif name.startswith("conv"):
            bound = cfg.ssm_conv ** -0.5
            mamba[name] = torch.empty(s, device=dev).uniform_(
                -bound, bound, generator=gen).to(cfg.dtype)
        else:
            mamba[name] = dense_init(gen, s, cfg.dtype)
    attn = {name: dense_init(gen, s, cfg.dtype, scale=(s[1] if name != "wo" else s[1] * s[2])
                             ** -0.5) for name, s in shapes["attn"].items()}
    return {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype, scale=0.02),
            "final_norm": zeros((cfg.d_model,)), "layers": layers, "mamba": mamba,
            "attn": attn}


def param_axes(cfg: ModelConfig) -> Params:
    """The stacked axis of every leaf; the rest unnamed (not sharded)."""
    shapes = param_shapes(cfg)
    out = {g: {name: ("layers",) + (None,) * (len(s) - 1) for name, s in leaves.items()}
           for g, leaves in shapes.items()}
    return {"embed": ("vocab", "embed"), "final_norm": ("embed",), **out}


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------
def _at(group: Dict[str, Tensor], i: int) -> Dict[str, Tensor]:
    return {k: v[i] for k, v in group.items()}


def _embed(params: Params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    x = params["embed"][tokens.long()]
    return x * cfg.embed_multiplier if cfg.embed_multiplier != 1.0 else x


def _head(params: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"]) / cfg.logits_scaling


def _ffn(lp: Dict[str, Tensor], y: Tensor, cfg: ModelConfig) -> Tensor:
    """The routed experts' share plus the shared expert."""
    moe_p = {"router": lp["moe_router"], "w_gate": lp["moe_w_gate"],
             "w_up": lp["moe_w_up"], "w_down": lp["moe_w_down"]}
    shared = {"w_gate": lp["shared_w_gate"], "w_up": lp["shared_w_up"],
              "w_down": lp["shared_w_down"]}
    return MOE.moe_share_ffn(moe_p, y, cfg) + M.gated_mlp(shared, y, cfg.activation)


def _conv_parts(mp: Dict[str, Tensor], name: str) -> Tuple[Tensor, Optional[Tensor]]:
    return mp[f"conv_{name}"], mp.get(f"conv_bias_{name}")


def ssd_chunks(log_a: Tensor, Bm: Tensor, Cm: Tensor, xdt: Tensor, h0: Tensor,
               chunk: int) -> Tuple[Tensor, Tensor]:
    """``mamba2._ssd_chunked``'s arithmetic with every SSD chunk at once:
    the chunks' quadratic forms and states as batched products, then the
    state entering each chunk from the chunk states and their decays (one
    product over chunk pairs), not a Python loop of ~15 launches a chunk.
    log_a (B,S,H); Bm/Cm (B,S,N); xdt (B,S,H,P); h0 (B,H,P,N) fp32.
    Returns (y (B,S,H,P) in xdt's dtype, h_final fp32)."""
    b, s, H = log_a.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
    nc = log_a.shape[1] // chunk
    la = log_a.float().reshape(b, nc, chunk, H)
    Bq = Bm.reshape(b, nc, chunk, -1)
    Cq = Cm.reshape(b, nc, chunk, -1)
    xq = xdt.float().reshape(b, nc, chunk, H, -1)
    cum = torch.cumsum(la, dim=2)                                          # (B,C,Q,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=la.device))
    decay = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~tri[None, None, :, :, None], float("-inf"))
    scores = torch.matmul(Cq, Bq.transpose(2, 3)).float()                 # (B,C,Q,Q)
    wts = (scores[..., None] * torch.exp(decay)).permute(0, 1, 4, 2, 3)    # (B,C,H,Q,Q)
    del decay
    y = torch.matmul(wts, xq.permute(0, 1, 3, 2, 4))                      # (B,C,H,Q,P)
    del wts
    total = cum[:, :, -1]                                                  # (B,C,H)
    w = torch.exp(total[:, :, None, :] - cum)                              # (B,C,Q,H)
    states = torch.matmul((xq * w[..., None]).permute(0, 1, 3, 4, 2),
                          Bq.float()[:, :, None])                          # (B,C,H,P,N)
    # the state entering chunk c: h0 and every earlier chunk's state,
    # decayed by the chunks between: exp(T_{c-1} - T_c') for c' < c
    ends = torch.cumsum(total, dim=1)                                      # (B,C,H)
    starts = ends - total
    pair = (starts[:, :, None, :] - ends[:, None, :, :]).masked_fill(
        ~torch.tril(torch.ones((nc, nc), dtype=torch.bool, device=la.device), -1)[
            None, :, :, None], float("-inf"))
    enter = torch.einsum("bcdh,bdhpn->bchpn", torch.exp(pair), states) + \
        h0.float()[:, None] * torch.exp(starts)[..., None, None]          # (B,C,H,P,N)
    y = y + torch.matmul(Cq.float()[:, :, None], enter.transpose(3, 4)) * \
        torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    h = enter[:, -1] * torch.exp(total[:, -1])[..., None, None] + states[:, -1]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * chunk, H, -1)[:, :s]
    return y.to(xdt.dtype), h


def mamba_mixer(cfg: ModelConfig, mp: Dict[str, Tensor], u: Tensor,
                conv_tail: Optional[Tensor], h0: Optional[Tensor]
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The Mamba-2 mixer on normed u (B, S, D) from the carried conv tail
    (B, cw-1, di+2N) and state h0 (B, H, P, N) fp32 (None: zeros). Returns
    (out (B, S, D), conv tail, h)."""
    b, s, _ = u.shape
    H, p, di, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_d_inner, cfg.ssm_state
    z = torch.matmul(u, mp["w_z"])
    dt = torch.matmul(u, mp["w_dt"]).float()
    tails = (None,) * 3 if conv_tail is None else torch.split(conv_tail, [di, n, n], dim=-1)
    parts = []
    for w, name, tail in zip(("w_x", "w_B", "w_C"), ("x", "B", "C"), tails):
        kernel, bias = _conv_parts(mp, name)
        parts.append(_causal_conv(torch.matmul(u, mp[w]), kernel, tail, bias))
    (xs, tx), (Bm, tB), (Cm, tC) = parts
    dt = softplus(dt + mp["dt_bias"][None, None])
    log_a = -torch.exp(mp["A_log"].float())[None, None] * dt
    xh = xs.reshape(b, s, H, p)
    xdt = xh * dt[..., None].to(xh.dtype)
    if h0 is None:
        h0 = torch.zeros((b, H, p, n), dtype=torch.float32, device=u.device)
    y, h = ssd_chunks(log_a, Bm, Cm, xdt, h0, cfg.ssm_chunk)
    y = y + mp["D"][None, None, :, None].to(y.dtype) * xh
    y = rms_norm(y.reshape(b, s, H * p) * F.silu(z), mp["norm"], cfg.norm_eps)
    return torch.matmul(y, mp["w_out"]), torch.cat([tx, tB, tC], dim=-1), h


def mamba_decode(cfg: ModelConfig, mp: Dict[str, Tensor], u: Tensor, h_slots: Tensor,
                 conv_slots: Tensor, slot_ids: Tensor) -> Tensor:
    """One token of the Mamba-2 mixer for each lane of u (B, 1, D), on the
    slots ``slot_ids`` (B,) of one layer's state: ``h_slots`` (S, H, P, N)
    fp32 and ``conv_slots`` (S, cw-1, di+2N), read and written in place
    (a lane's slot must be its own, or a scratch slot shared only by pad
    lanes). Returns out (B, 1, D). The arithmetic is :func:`mamba_mixer`'s
    on one token: the conv over the tail and the token, then
    ``h = exp(log a) h + (x dt) B^T``, ``y = h C + D x``."""
    b = u.shape[0]
    H, p, di, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_d_inner, cfg.ssm_state
    z = torch.matmul(u, mp["w_z"])
    dt = torch.matmul(u, mp["w_dt"]).float()[:, 0]                       # (B, H)
    tail = conv_slots.index_select(0, slot_ids)                          # (B, cw-1, C)
    tails = torch.split(tail, [di, n, n], dim=-1)
    acts = []
    for w, name, t in zip(("w_x", "w_B", "w_C"), ("x", "B", "C"), tails):
        kernel, bias = _conv_parts(mp, name)
        acts.append(_causal_conv(torch.matmul(u, mp[w]), kernel, t, bias))
    conv_slots.index_copy_(0, slot_ids, torch.cat([a[1] for a in acts], dim=-1))
    xs, Bm, Cm = (a[0][:, 0] for a in acts)
    dt = softplus(dt + mp["dt_bias"][None])
    decay = torch.exp(-torch.exp(mp["A_log"].float())[None] * dt)      # (B, H)
    xh = xs.reshape(b, H, p)
    xdt = (xh * dt[..., None].to(xh.dtype)).float()
    h = h_slots.index_select(0, slot_ids)                                # (B, H, P, N)
    h.mul_(decay[..., None, None]).addcmul_(xdt[..., None], Bm.float()[:, None, None, :])
    h_slots.index_copy_(0, slot_ids, h)
    y = torch.matmul(h, Cm.float()[:, None, :, None])[..., 0].to(xh.dtype)  # (B, H, P)
    y = y + mp["D"][None, :, None].to(y.dtype) * xh
    y = rms_norm(y.reshape(b, 1, H * p) * F.silu(z), mp["norm"], cfg.norm_eps)
    return torch.matmul(y, mp["w_out"])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def _body(params: Params, cfg: ModelConfig, tokens: Tensor,
          prefix_k: Optional[Tensor] = None, prefix_v: Optional[Tensor] = None,
          conv: Optional[Tensor] = None, h: Optional[Tensor] = None):
    """The layer stack over tokens (B, S) after ``prefix_k/v`` (La, B, C,
    KV, hd) and from the carried state ``conv`` (Lm, B, cw-1, di+2N) and
    ``h`` (Lm, B, H, P, N). Returns (x (B, S, D), ks, vs, convs, hs)."""
    x = _embed(params, cfg, tokens)
    c = 0 if prefix_k is None else prefix_k.shape[2]
    positions = c + torch.arange(x.shape[1], device=x.device)[None, :]
    rm = cfg.residual_multiplier
    ks, vs, convs, hs = [], [], [], []
    for i, (kind, j) in enumerate(mixer_index(cfg)):
        lp = _at(params["layers"], i)
        hn = rms_norm(x, lp["norm_mixer"], cfg.norm_eps)
        if kind == "mamba":
            out, tail, hf = mamba_mixer(cfg, _at(params["mamba"], j), hn,
                                        None if conv is None else conv[j],
                                        None if h is None else h[j])
            convs.append(tail)
            hs.append(hf)
        elif prefix_k is None:
            out, (k, v) = A.self_attention(_at(params["attn"], j), hn, cfg, positions)
        else:
            out, (k, v) = A.suffix_attention(_at(params["attn"], j), hn, cfg, positions,
                                             prefix_k[j], prefix_v[j])
        if kind == "attn":
            ks.append(k)
            vs.append(v)
        x = x + out * rm
        x = x + _ffn(lp, rms_norm(x, lp["norm_ffn"], cfg.norm_eps), cfg) * rm
    return x, ks, vs, convs, hs


def prefill_chunk(params: Params, cfg: ModelConfig, tokens: Tensor,
                  prefix_k: Optional[Tensor] = None, prefix_v: Optional[Tensor] = None,
                  conv: Optional[Tensor] = None, h: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Dict[str, Tensor], Tensor, Tensor]:
    """One prefill chunk: tokens (B, S) after the resident prefix
    (``prefix_k/v`` (La, B, C, KV, hd), None for the first chunk), from the
    carried state ``conv`` / ``h`` (None: zeros). Returns (last-position
    logits (B, V) fp32, {"k", "v"} (La, B, S, KV, hd) of the chunk only, the
    new conv tails (Lm, B, cw-1, di+2N), the new h (Lm, B, H, P, N) fp32)."""
    x, ks, vs, convs, hs = _body(params, cfg, tokens, prefix_k, prefix_v, conv, h)
    logits = _head(params, cfg, x[:, -1:])[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}, torch.stack(convs), \
        torch.stack(hs)


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The whole prompt from a zero state: last-position logits and the
    cache (k, v, conv, h, length)."""
    logits, kv, conv, h = prefill_chunk(params, cfg, tokens)
    length = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                        device=tokens.device)
    return logits, {**kv, "conv": conv, "h": h, "length": length}


def forward_train(params: Params, cfg: ModelConfig, tokens: Tensor,
                  frontend_embeds=None) -> Tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32 at every position, aux 0)."""
    x = _body(params, cfg, tokens)[0]
    return _head(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]) -> Tensor:
    logits, _ = forward_train(params, cfg, batch["tokens"])
    mask = batch.get("loss_mask")
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                                 None if mask is None else mask[:, 1:])


def decode_step_paged(params: Params, cfg: ModelConfig, token: Tensor, pool: Tensor,
                      block_tables: Tensor, lengths: Tensor, slot_ids: Tensor,
                      slots) -> Tuple[Tensor, Tensor]:
    """One batched decode step over the paged pool and the state slots.

    token (B,); pool (nb, La, 2, payload); block_tables (B, W); lengths (B,)
    cached tokens per lane; slot_ids (B,) each lane's slot in ``slots``
    (``serving/state_slots.StateSlots``: ``h`` (S, Lm, H, P, N) fp32 and
    ``conv`` (S, Lm, cw-1, di+2N)). Attention reads the pool through K3 a
    layer and the batch's K/V lands with one K1 append after the stack;
    the Mamba-2 layers read and write their slots in place. Returns (logits
    (B, V) fp32, pool). Static shapes, nothing read on the host."""
    from repro_torch.kernels.kv_gather import kv_append_tokens

    x = _embed(params, cfg, token[:, None])
    rm = cfg.residual_multiplier
    slot_ids = slot_ids.long()
    ks, vs = [], []
    for i, (kind, j) in enumerate(mixer_index(cfg)):
        lp = _at(params["layers"], i)
        hn = rms_norm(x, lp["norm_mixer"], cfg.norm_eps)
        if kind == "mamba":
            out = mamba_decode(cfg, _at(params["mamba"], j), hn, slots.h[:, j],
                               slots.conv[:, j], slot_ids)
        else:
            out, (k1, v1) = A.decode_paged_self_attention(
                _at(params["attn"], j), hn, cfg, pool, block_tables, lengths, layer=j)
            ks.append(k1)
            vs.append(v1)
        x = x + out * rm
        x = x + _ffn(lp, rms_norm(x, lp["norm_ffn"], cfg.norm_eps), cfg) * rm
    kv_append_tokens(pool, block_tables, lengths, torch.stack(ks), torch.stack(vs),
                     block_size=cfg.block_size)
    return _head(params, cfg, x)[:, 0], pool


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Tensor]:
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    kinds = cfg.layer_kinds()
    La, Lm = kinds.count("attn"), kinds.count("mamba")
    kv = (La, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
            "conv": torch.zeros((Lm, batch, cfg.ssm_conv - 1, conv_width(cfg)), dtype=dtype,
                                device=dev),
            "h": torch.zeros((Lm, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=dev),
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def cache_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            "conv": ("layers", "batch", "conv", "inner"),
            "h": ("layers", "batch", "heads", "head_dim", "state"),
            "length": ("batch",)}
