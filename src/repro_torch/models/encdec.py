"""Encoder-decoder backbone (seamless-m4t-large-v2). Port of
``repro/models/encdec.py``.

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model). The encoder is
bidirectional; above ``cfg.flash_threshold`` frames its attention is K4 in
non-causal mode (``kernels/flash_prefill``) when serving and the chunked
``models/flash.py`` when training (K4 has no backward), at or below it the
plain :func:`attention.attend`, as the reference switches between its
chunked flash and ``attend``. The decoder is a causal transformer with
cross-attention into per-layer K/V projected once from the encoder output.

Decode writes the new token's K/V at ``length``, so it needs a cache of
``init_cache(max_len)`` with the prefill's K/V copied in (the prefill's own
cache holds exactly the prompt), as the reference's tests do.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as MLPM
from repro_torch.models.common import (ModelConfig, dense_init, embed, make_generator,
                                       maybe_remat, rms_norm, softmax_cross_entropy,
                                       unbind_layers, unembed)
from repro_torch.models.transformer import _head

Params = Dict[str, Any]
Tensor = torch.Tensor
_MLP = ("w_gate", "w_up", "w_down")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random params from a ``torch.Generator`` seeded with ``seed``, in the
    reference's layout (tests bridge the reference's own init instead)."""
    dev = resolve_device(device)
    gen = make_generator(dev, seed)
    d = cfg.d_model

    def block(L: int, with_cross: bool) -> Params:
        p = {name: dense_init(gen, (L, *shape), cfg.dtype)
             for name, shape in A.attn_param_shapes(cfg).items()}
        p["norm_attn"] = torch.zeros((L, d), dtype=cfg.dtype, device=dev)
        p["norm_mlp"] = torch.zeros((L, d), dtype=cfg.dtype, device=dev)
        for name, shape in MLPM.mlp_param_shapes(cfg).items():
            p[name] = dense_init(gen, (L, *shape), cfg.dtype)
        if with_cross:
            for name, shape in A.cross_param_shapes(cfg).items():
                p[f"x_{name}"] = dense_init(gen, (L, *shape), cfg.dtype)
            p["norm_cross"] = torch.zeros((L, d), dtype=cfg.dtype, device=dev)
        return p

    return {
        "embed": dense_init(gen, (cfg.vocab_size, d), cfg.dtype, 0.02),
        "enc_in_norm": torch.zeros((d,), dtype=cfg.dtype, device=dev),
        "encoder": block(cfg.num_encoder_layers, with_cross=False),
        "decoder": block(cfg.num_layers, with_cross=True),
        "enc_final_norm": torch.zeros((d,), dtype=cfg.dtype, device=dev),
        "final_norm": torch.zeros((d,), dtype=cfg.dtype, device=dev),
    }


def param_axes(cfg: ModelConfig) -> Params:
    def block_axes(with_cross: bool):
        ax = {name: ("layers", *a) for name, a in A.attn_param_axes(cfg).items()}
        ax["norm_attn"] = ("layers", "embed")
        ax["norm_mlp"] = ("layers", "embed")
        for name, a in MLPM.mlp_param_axes().items():
            ax[name] = ("layers", *a)
        if with_cross:
            ax.update({
                "x_wq": ("layers", "embed", "heads", "head_dim"),
                "x_wk": ("layers", "embed", "kv_heads", "head_dim"),
                "x_wv": ("layers", "embed", "kv_heads", "head_dim"),
                "x_wo": ("layers", "heads", "head_dim", "embed"),
                "norm_cross": ("layers", "embed"),
            })
        return ax

    return {
        "embed": ("vocab", "embed"),
        "enc_in_norm": ("embed",),
        "encoder": block_axes(False),
        "decoder": block_axes(True),
        "enc_final_norm": ("embed",),
        "final_norm": ("embed",),
    }


def _layer(stack: Params, i: int) -> Params:
    return {k: v[i] for k, v in stack.items()}


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def _encoder_layer(cfg: ModelConfig, positions: Tensor, train: bool, x: Tensor,
                   lp: Params) -> Tensor:
    hn = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    q, k, v = A.qkv_project(lp, hn, cfg, positions)
    if x.shape[1] <= cfg.flash_threshold:
        attn = A.attend(q, k, v, None)
    elif train:
        from repro_torch.models.flash import flash_attention
        attn = flash_attention(q, k, v, causal=False, q_chunk=cfg.attn_q_chunk,
                               kv_chunk=cfg.attn_kv_chunk)
    else:
        from repro_torch.kernels.flash_prefill import flash_prefill_op
        attn = flash_prefill_op(q, k, v, causal=False)
    x = x + A.out_project(lp, attn)
    hn = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
    return x + MLPM.gated_mlp({k2: lp[k2] for k2 in _MLP}, hn, cfg.activation)


def encode(params: Params, cfg: ModelConfig, frames: Tensor, train: bool = False) -> Tensor:
    """frames (B, S_enc, D) -> encoder output (B, S_enc, D). Bidirectional;
    ``train`` takes the differentiable attention and ``cfg.remat``."""
    x = rms_norm(frames.to(cfg.dtype), params["enc_in_norm"], cfg.norm_eps)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layer = functools.partial(_encoder_layer, cfg, positions, train)
    if train:
        layer = maybe_remat(layer, cfg)
    for lp in unbind_layers(params["encoder"]):
        x = layer(x, lp)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def encode_cross_kv(params: Params, cfg: ModelConfig, memory: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Project encoder output into per-decoder-layer cross K/V, each
    (L_dec, B, S_enc, KV, hd): part of a request's state."""
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["decoder"], i)
        k, v = A.encode_memory({"wk": lp["x_wk"], "wv": lp["x_wv"]}, memory)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _cross_and_mlp(cfg: ModelConfig, lp: Params, h: Tensor, xk: Tensor, xv: Tensor
                   ) -> Tensor:
    hn = rms_norm(h, lp["norm_cross"], cfg.norm_eps)
    h = h + A.cross_attention({"wq": lp["x_wq"], "wo": lp["x_wo"]}, hn, (xk, xv), cfg)
    hn = rms_norm(h, lp["norm_mlp"], cfg.norm_eps)
    return h + MLPM.gated_mlp({k2: lp[k2] for k2 in _MLP}, hn, cfg.activation)


def _decoder_layer(cfg: ModelConfig, lp: Params, h: Tensor, positions: Tensor,
                   xk: Tensor, xv: Tensor, train: bool = False
                   ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    hn = rms_norm(h, lp["norm_attn"], cfg.norm_eps)
    attn, (k, v) = A.self_attention(lp, hn, cfg, positions, train=train)
    return _cross_and_mlp(cfg, lp, h + attn, xk, xv), (k, v)


def _decoder_layer_train(cfg: ModelConfig, positions: Tensor, h: Tensor, lp: Params,
                         xk: Tensor, xv: Tensor) -> Tensor:
    return _decoder_layer(cfg, lp, h, positions, xk, xv, train=True)[0]


def forward_train(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]
                  ) -> Tuple[Tensor, Tensor]:
    """batch: frames (B, S_enc, D) + tokens (B, S_dec) -> (decoder logits
    (B, S_dec, V) fp32, aux_loss = 0)."""
    memory = encode(params, cfg, batch["frames"], train=True)
    x = embed(batch["tokens"], params["embed"], cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = maybe_remat(functools.partial(_decoder_layer_train, cfg, positions), cfg)
    for lp in unbind_layers(params["decoder"]):
        xk, xv = A.encode_memory({"wk": lp["x_wk"], "wv": lp["x_wv"]}, memory)
        x = body(x, lp, xk, xv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"]), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]) -> Tensor:
    logits, _ = forward_train(params, cfg, batch)
    mask = batch.get("loss_mask")
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                                 None if mask is None else mask[:, 1:])


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Encoder + decoder-prompt prefill of ``batch`` = {frames (B,S_enc,D),
    tokens (B,S_dec)}. Cache = the decoder's self K/V (prompt length) plus
    the cross K/V."""
    memory = encode(params, cfg, batch["frames"])
    xk, xv = encode_cross_kv(params, cfg, memory)
    tokens = batch["tokens"]
    x = embed(tokens, params["embed"], cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _decoder_layer(cfg, _layer(params["decoder"], i), x, positions,
                                   xk[i], xv[i])
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "cross_k": xk, "cross_v": xv,
             "length": torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                                  device=x.device)}
    return _head(params, cfg, x[:, -1:]), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               dtype=None, device=None) -> Dict[str, Tensor]:
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((L, batch, max_len, kv, hd), dtype=dtype, device=dev),
        "v": torch.zeros((L, batch, max_len, kv, hd), dtype=dtype, device=dev),
        "cross_k": torch.zeros((L, batch, enc_len, kv, hd), dtype=dtype, device=dev),
        "cross_v": torch.zeros((L, batch, enc_len, kv, hd), dtype=dtype, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def cache_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "cross_k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "cross_v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "length": ("batch",),
    }


def decode_step(params: Params, cfg: ModelConfig, token: Tensor,
                cache: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """token (B,) int; the new token's self K/V is written into
    ``cache["k"]`` / ``cache["v"]`` in place at ``length`` (so the cache
    must have room past the prompt); ``length`` comes back as a new tensor."""
    x = embed(token[:, None], params["embed"], cfg.embed_scale)
    position = cache["length"]
    for i in range(cfg.num_layers):
        lp = _layer(params["decoder"], i)
        hn = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
        attn, _ = A.decode_self_attention(lp, hn, cfg, cache["k"][i], cache["v"][i],
                                          position)
        x = _cross_and_mlp(cfg, lp, x + attn, cache["cross_k"][i], cache["cross_v"][i])
    return _head(params, cfg, x), {"k": cache["k"], "v": cache["v"],
                                   "cross_k": cache["cross_k"],
                                   "cross_v": cache["cross_v"],
                                   "length": cache["length"] + 1}
