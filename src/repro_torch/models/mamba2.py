"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060). Port of
``repro/models/mamba2.py``.

Chunked SSD: the sequence is cut into chunks of Q tokens; inside a chunk
the output is a masked, decay-weighted "attention" product, and a recurrent
state h (B, H, P, N) is carried across chunks (a Python loop where the
reference scans). Decode is the same computation on one token, the O(1)
update ``h = a*h + B ⊗ x·dt; y = C·h``.

Per layer (ngroups = 1, B/C shared across heads)::

    z, xs, Bm, Cm, dt = projections(u)
    xs, Bm, Cm <- causal depthwise conv (window 4) + silu
    dt = softplus(dt + dt_bias);  log a = -exp(A_log) * dt
    y = SSD(log a, Bm, Cm, xs * dt) + D * xs
    out = W_out @ rms_norm(y * silu(z))

A request's state is five tensors whatever its prompt length: the three
conv tails, the fp32 ``h`` of every layer and ``length`` — what the state
transfer path moves P -> D (``core/transfer.StateBackend``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.obs.counting import trips
from repro_torch.models.common import (ModelConfig, dense_init, embed, make_generator,
                                       maybe_remat, rms_norm, softmax_cross_entropy,
                                       unbind_layers, unembed)
from repro_torch.models.transformer import _head, layer_params

Params = Dict[str, Any]
Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random params from a ``torch.Generator`` seeded with ``seed``, in the
    reference's layout (tests bridge the reference's own init instead)."""
    dev = resolve_device(device)
    gen = make_generator(dev, seed)
    L, d = cfg.num_layers, cfg.d_model
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.ssm_conv

    def stack(shape, scale=None):
        return dense_init(gen, (L, *shape), cfg.dtype, scale)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev)).expand(L, h)
    layer = {
        "w_z": stack((d, di)),
        "w_x": stack((d, di)),
        "w_B": stack((d, n)),
        "w_C": stack((d, n)),
        "w_dt": stack((d, h)),
        "conv_x": stack((cw, di), scale=cw ** -0.5),
        "conv_B": stack((cw, n), scale=cw ** -0.5),
        "conv_C": stack((cw, n), scale=cw ** -0.5),
        "A_log": a_log.contiguous(),
        "D": torch.ones((L, h), dtype=cfg.dtype, device=dev),
        "dt_bias": torch.zeros((L, h), dtype=torch.float32, device=dev),
        "norm": torch.zeros((L, di), dtype=cfg.dtype, device=dev),
        "w_out": stack((di, d)),
        "norm_in": torch.zeros((L, d), dtype=cfg.dtype, device=dev),
    }
    return {
        "embed": dense_init(gen, (cfg.vocab_size, d), cfg.dtype, 0.02),
        "final_norm": torch.zeros((d,), dtype=cfg.dtype, device=dev),
        "layers": layer,
    }


def param_axes(cfg: ModelConfig) -> Params:
    lx = {
        "w_z": ("layers", "embed", "inner"),
        "w_x": ("layers", "embed", "inner"),
        "w_B": ("layers", "embed", "state"),
        "w_C": ("layers", "embed", "state"),
        "w_dt": ("layers", "embed", "heads"),
        "conv_x": ("layers", "conv", "inner"),
        "conv_B": ("layers", "conv", "state"),
        "conv_C": ("layers", "conv", "state"),
        "A_log": ("layers", "heads"),
        "D": ("layers", "heads"),
        "dt_bias": ("layers", "heads"),
        "norm": ("layers", "inner"),
        "w_out": ("layers", "inner", "embed"),
        "norm_in": ("layers", "embed"),
    }
    return {"embed": ("vocab", "embed"), "final_norm": ("embed",), "layers": lx}


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------
def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus`` (logaddexp(x, 0)): no threshold, unlike F.softplus."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: Tensor, w: Tensor, state: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv. x (B,S,C), w (cw,C); state (B,cw-1,C) carries
    the last cw-1 inputs across calls. Returns (silu(out), new_state)."""
    cw = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xx = torch.cat([state.to(x.dtype), x], dim=1)            # (B, S+cw-1, C)
    out = sum(xx[:, i:i + x.shape[1]] * w[i][None, None] for i in range(cw))
    new_state = xx[:, -(cw - 1):] if cw > 1 else state
    return F.silu(out), new_state


def _ssd_chunked(log_a: Tensor, Bm: Tensor, Cm: Tensor, xdt: Tensor,
                 h0: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan.

    log_a (B,S,H); Bm/Cm (B,S,N); xdt (B,S,H,P); h0 (B,H,P,N).
    Returns (y (B,S,H,P) in xdt's dtype, h_final fp32).

    The reference's three-operand ``einsum("bts,btsh,bshp->bthp")`` is two
    fixed steps here, the weights ``scores * gamma`` (B,T,S,H) and then a
    batched matmul over s, so no (T, S, H, P) product is ever formed.
    """
    b, s, H = log_a.shape
    p = xdt.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
    nc = log_a.shape[1] // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=log_a.device))
    h = h0.float()
    ys = []
    loop = trips(nc, xdt)             # every chunk has one shape (padded)
    for c in loop:
        sl = slice(c * chunk, (c + 1) * chunk)
        la, Bq, Cq, xq = log_a[:, sl].float(), Bm[:, sl], Cm[:, sl], xdt[:, sl].float()
        cum = torch.cumsum(la, dim=1)                            # (B,Q,H)
        # intra-chunk: y[t] = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) x_s
        decay = cum[:, :, None, :] - cum[:, None, :, :]          # (B,T,S,H)
        decay = decay.masked_fill(~tri[None, :, :, None], float("-inf"))
        gamma = torch.exp(decay)
        scores = torch.matmul(Cq, Bq.transpose(1, 2)).float()   # (B,T,S)
        wts = (scores[..., None] * gamma).permute(0, 3, 1, 2)    # (B,H,T,S)
        y_intra = torch.matmul(wts, xq.permute(0, 2, 1, 3))     # (B,H,T,P)
        # inter-chunk: y[t] += exp(cum_t) * (C_t . h0)
        ch = torch.matmul(Cq.float()[:, None], h.transpose(2, 3))   # (B,H,T,P)
        y_inter = ch * torch.exp(cum).permute(0, 2, 1)[..., None]
        ys.append((y_intra + y_inter).permute(0, 2, 1, 3))      # (B,T,H,P)
        # state update: h' = exp(cum_Q) h + sum_s exp(cum_Q - cum_s) B_s x_s
        total = cum[:, -1]                                       # (B,H)
        w = torch.exp(total[:, None, :] - cum)                   # (B,Q,H)
        xw = (xq * w[..., None]).permute(0, 2, 3, 1)             # (B,H,P,S)
        h = h * torch.exp(total)[:, :, None, None] + torch.matmul(xw, Bq.float()[:, None])
    y = torch.cat(ys * loop.reps, dim=1)[:, :s]
    return y.to(xdt.dtype), h


def _layer(cfg: ModelConfig, lp: Params, u: Tensor, conv_state=None,
           h0: Optional[Tensor] = None) -> Tuple[Tensor, Tuple[Tensor, ...], Tensor]:
    """One mamba2 block on u (B,S,D). Returns (out, conv_states, h_final)."""
    b, s, _ = u.shape
    H, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x_res = u
    u = rms_norm(u, lp["norm_in"], cfg.norm_eps)
    z = torch.matmul(u, lp["w_z"])
    xs = torch.matmul(u, lp["w_x"])
    Bm = torch.matmul(u, lp["w_B"])
    Cm = torch.matmul(u, lp["w_C"])
    dt = torch.matmul(u, lp["w_dt"]).float()

    cs_x, cs_B, cs_C = conv_state if conv_state is not None else (None, None, None)
    xs, cs_x = _causal_conv(xs, lp["conv_x"], cs_x)
    Bm, cs_B = _causal_conv(Bm, lp["conv_B"], cs_B)
    Cm, cs_C = _causal_conv(Cm, lp["conv_C"], cs_C)

    dt = softplus(dt + lp["dt_bias"][None, None])
    log_a = -torch.exp(lp["A_log"].float())[None, None] * dt     # (B,S,H)
    xh = xs.reshape(b, s, H, p)
    xdt = xh * dt[..., None].to(xh.dtype)

    if h0 is None:
        h0 = torch.zeros((b, H, p, n), dtype=torch.float32, device=u.device)
    y, h_final = _ssd_chunked(log_a, Bm, Cm, xdt, h0, cfg.ssm_chunk)
    y = y + lp["D"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(b, s, H * p)
    y = rms_norm(y * F.silu(z), lp["norm"], cfg.norm_eps)
    out = torch.matmul(y, lp["w_out"])
    return x_res + out.to(x_res.dtype), (cs_x, cs_B, cs_C), h_final


# ---------------------------------------------------------------------------
# Entry points (the protocol of models/transformer.py)
# ---------------------------------------------------------------------------
def _layer_train(cfg: ModelConfig, u: Tensor, lp: Params) -> Tensor:
    return _layer(cfg, lp, u)[0]


def forward_train(params: Params, cfg: ModelConfig, tokens: Tensor,
                  frontend_embeds=None) -> Tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, aux_loss = 0)."""
    x = embed(tokens, params["embed"], cfg.embed_scale)
    body = maybe_remat(functools.partial(_layer_train, cfg), cfg)
    for lp in unbind_layers(params["layers"]):
        x = body(x, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"]), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]) -> Tensor:
    logits, _ = forward_train(params, cfg, batch["tokens"])
    mask = batch.get("loss_mask")
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                                 None if mask is None else mask[:, 1:])


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor,
            frontend_embeds=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Last-position logits (B, V) fp32 and the request state."""
    x = embed(tokens, params["embed"], cfg.embed_scale)
    convs, hs = [], []
    for i in range(cfg.num_layers):
        x, conv, hf = _layer(cfg, layer_params(params, i), x)
        convs.append(conv)
        hs.append(hf)
    cache = {
        "conv_x": torch.stack([c[0] for c in convs]),      # (L,B,cw-1,*)
        "conv_B": torch.stack([c[1] for c in convs]),
        "conv_C": torch.stack([c[2] for c in convs]),
        "h": torch.stack(hs),                              # (L,B,H,P,N)
        "length": torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                             device=x.device),
    }
    return _head(params, cfg, x[:, -1:]), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, dtype=None,
               device=None) -> Dict[str, Tensor]:
    del max_len  # state size is O(1) in sequence length
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    L, cw = cfg.num_layers, cfg.ssm_conv
    di, n, H, p = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "conv_x": torch.zeros((L, batch, cw - 1, di), dtype=dtype, device=dev),
        "conv_B": torch.zeros((L, batch, cw - 1, n), dtype=dtype, device=dev),
        "conv_C": torch.zeros((L, batch, cw - 1, n), dtype=dtype, device=dev),
        "h": torch.zeros((L, batch, H, p, n), dtype=torch.float32, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def cache_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "conv_x": ("layers", "batch", "conv", "inner"),
        "conv_B": ("layers", "batch", "conv", "state"),
        "conv_C": ("layers", "batch", "conv", "state"),
        "h": ("layers", "batch", "heads", "head_dim", "state"),
        "length": ("batch",),
    }


def decode_step(params: Params, cfg: ModelConfig, token: Tensor,
                cache: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """token (B,) int; returns (logits (B, V) fp32, a new cache; the
    input cache is not modified)."""
    x = embed(token[:, None], params["embed"], cfg.embed_scale)
    cx, cb, cc, hs = [], [], [], []
    for i in range(cfg.num_layers):
        conv = (cache["conv_x"][i], cache["conv_B"][i], cache["conv_C"][i])
        x, conv, hf = _layer(cfg, layer_params(params, i), x, conv_state=conv,
                             h0=cache["h"][i])
        cx.append(conv[0])
        cb.append(conv[1])
        cc.append(conv[2])
        hs.append(hf)
    return _head(params, cfg, x), {
        "conv_x": torch.stack(cx), "conv_B": torch.stack(cb), "conv_C": torch.stack(cc),
        "h": torch.stack(hs), "length": cache["length"] + 1}
