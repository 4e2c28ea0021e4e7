"""Decoder-only transformer LM: the dense, MoE and VLM/backbone configs.
Port of ``repro/models/transformer.py``.

Params keep the reference's names and layouts: layer parameters stacked on
a leading ``layers`` axis (``wq (L, d, H, hd)``, ``wo (L, H, hd, d)``, ...);
a Python loop over layers replaces ``jax.lax.scan``. Pre-norm residual
blocks::

    x = x + Attn(RMSNorm(x));  x = x + FFN(RMSNorm(x))

FFN is the gated MLP, or for the MoE family one of ``models/moe.py``'s
dispatches (chosen as the reference's ``_ffn`` chooses). A VLM's
``frontend_embeds`` are spliced in front of the text embeddings.

``forward_train`` / ``loss_fn`` are the training forward: the stacked
leaves are unbound once (``common.unbind_layers``), each layer is one
``maybe_remat`` call, attention above ``flash_threshold`` is the chunked
``models/flash.py`` (never K4, which has no backward), and the MoE aux
loss is summed over layers.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models.common import (ModelConfig, dense_init, embed, make_generator,
                                       maybe_remat, rms_norm, softmax_cross_entropy,
                                       unbind_layers, unembed)

Params = Dict[str, Any]
Tensor = torch.Tensor


def _require_transformer(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "audio"):
        raise ValueError(f"family {cfg.family!r} is not a transformer: its model is "
                         "models/mamba2.py, griffin.py or encdec.py (models/api.get_model)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random params from an explicit ``torch.Generator`` seeded with ``seed``
    (no claim to reproduce ``jax.random``; tests bridge the reference's own
    init through :func:`repro_torch.models.bridge.from_reference`)."""
    _require_transformer(cfg)
    dev = resolve_device(device)
    gen = make_generator(dev, seed)
    L, d = cfg.num_layers, cfg.d_model
    layer: Dict[str, Tensor] = {
        name: dense_init(gen, (L, *shape), cfg.dtype)
        for name, shape in A.attn_param_shapes(cfg).items() if name not in ("q_norm", "k_norm")
    }
    if cfg.qk_norm:
        layer["q_norm"] = torch.zeros((L, cfg.head_dim), dtype=cfg.dtype, device=dev)
        layer["k_norm"] = torch.zeros((L, cfg.head_dim), dtype=cfg.dtype, device=dev)
    layer["norm_attn"] = torch.zeros((L, d), dtype=cfg.dtype, device=dev)
    layer["norm_mlp"] = torch.zeros((L, d), dtype=cfg.dtype, device=dev)
    if cfg.family == "moe":
        for name, shape in MOE.moe_param_shapes(cfg).items():
            layer[f"moe_{name}"] = dense_init(gen, (L, *shape), cfg.dtype)
    else:
        for name, shape in M.mlp_param_shapes(cfg).items():
            layer[name] = dense_init(gen, (L, *shape), cfg.dtype)
    params: Params = {
        "embed": dense_init(gen, (cfg.vocab_size, d), cfg.dtype, scale=0.02),
        "final_norm": torch.zeros((d,), dtype=cfg.dtype, device=dev),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.vocab_size, d), cfg.dtype, scale=0.02)
    return params


def param_axes(cfg: ModelConfig) -> Params:
    """The logical axes of every param leaf (same structure as the params):
    the rule table ``distributed/sharding.spec_for`` reads."""
    layer_axes: Dict[str, Tuple[Optional[str], ...]] = {
        name: ("layers", *ax) for name, ax in A.attn_param_axes(cfg).items()
    }
    layer_axes["norm_attn"] = ("layers", "embed")
    layer_axes["norm_mlp"] = ("layers", "embed")
    if cfg.family == "moe":
        for name, ax in MOE.moe_param_axes().items():
            layer_axes[f"moe_{name}"] = ("layers", *ax)
    else:
        for name, ax in M.mlp_param_axes().items():
            layer_axes[name] = ("layers", *ax)
    axes: Params = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "layers": layer_axes,
    }
    if not cfg.tie_embeddings:
        axes["unembed"] = ("vocab", "embed")
    return axes


def layer_params(params: Params, i: int) -> Dict[str, Tensor]:
    """Layer ``i``'s slice of the stacked layer params (views, no copies)."""
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _ffn_aux(lp: Params, x: Tensor, cfg: ModelConfig
             ) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's FFN output and the MoE dispatch's aux loss (None for a
    dense FFN)."""
    if cfg.family == "moe":
        moe_p = {k[len("moe_"):]: v for k, v in lp.items() if k.startswith("moe_")}
        if MOE.host_routed(cfg):
            return MOE.moe_ffn_topk_sparse(moe_p, x, cfg)
        if cfg.moe_dispatch == "gshard":
            return MOE.moe_ffn_gshard(moe_p, x, cfg, cfg.moe_capacity_factor)
        if cfg.moe_dispatch == "gshard_einsum":
            return MOE.moe_ffn_gshard_einsum(moe_p, x, cfg, cfg.moe_capacity_factor)
        return MOE.moe_ffn(moe_p, x, cfg)
    return M.gated_mlp(lp, x, cfg.activation), None


def _ffn(lp: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """The block's FFN output; the aux loss (a training term) is dropped, as
    the reference's serving paths drop it."""
    return _ffn_aux(lp, x, cfg)[0]


def _layer_train(cfg: ModelConfig, positions: Tensor, x: Tensor, lp: Params
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """One training layer on x (B, S, D): (out, aux or None)."""
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    attn_out, _ = A.self_attention(lp, h, cfg, positions, cfg.attn_window, train=True)
    x = x + attn_out
    ffn_out, aux = _ffn_aux(lp, rms_norm(x, lp["norm_mlp"], cfg.norm_eps), cfg)
    return x + ffn_out, aux


def _head(params: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params.get("unembed", params["embed"]))[:, 0]


def _input_embeds(params: Params, cfg: ModelConfig, tokens: Tensor,
                  frontend_embeds: Optional[Tensor]) -> Tensor:
    x = embed(tokens, params["embed"], scale=cfg.embed_scale)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward_train(params: Params, cfg: ModelConfig, tokens: Tensor,
                  frontend_embeds: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """tokens (B, S_text) -> (logits (B, S_total, V) fp32, aux_loss)."""
    x = _input_embeds(params, cfg, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = maybe_remat(functools.partial(_layer_train, cfg, positions), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unbind_layers(params["layers"]):
        x, aux_i = body(x, lp)
        if aux_i is not None:
            aux = aux + aux_i
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params.get("unembed", params["embed"])), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]) -> Tensor:
    """Next-token NLL over ``batch`` = {tokens, labels, optional loss_mask,
    optional frontend_embeds} plus 0.01 x the MoE aux loss."""
    logits, aux = forward_train(params, cfg, batch["tokens"], batch.get("frontend_embeds"))
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if logits.shape[1] != labels.shape[1]:       # frontend positions carry no labels
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    loss = softmax_cross_entropy(logits[:, :-1], labels[:, 1:],
                                 None if mask is None else mask[:, 1:])
    return loss + 0.01 * aux


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor,
            frontend_embeds: Optional[Tensor] = None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence forward; returns last-position logits (B, V) fp32 and
    the dense KV cache k/v (L, B, S, KV, hd) + length (B,)."""
    x = _input_embeds(params, cfg, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
        attn_out, (k, v) = A.self_attention(lp, h, cfg, positions, cfg.attn_window)
        x = x + attn_out
        x = x + _ffn(lp, rms_norm(x, lp["norm_mlp"], cfg.norm_eps), cfg)
        ks.append(k)
        vs.append(v)
    logits = _head(params, cfg, x[:, -1:])
    length = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "length": length}


def prefill_suffix(params: Params, cfg: ModelConfig, tokens: Tensor,
                   prefix_k: Tensor, prefix_v: Tensor
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Suffix-only prefill over a resident prefix: tokens (B, S_suf) after
    the cached prefix; prefix_k/v (L, B, C, KV, hd). Returns (logits (B, V)
    fp32, cache with k/v covering ONLY the suffix)."""
    x = _input_embeds(params, cfg, tokens, None)
    c = prefix_k.shape[2]
    positions = c + torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        hn = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
        attn_out, (k, v) = A.suffix_attention(lp, hn, cfg, positions, prefix_k[i],
                                              prefix_v[i], cfg.attn_window)
        x = x + attn_out
        x = x + _ffn(lp, rms_norm(x, lp["norm_mlp"], cfg.norm_eps), cfg)
        ks.append(k)
        vs.append(v)
    logits = _head(params, cfg, x[:, -1:])
    length = torch.full((tokens.shape[0],), c + x.shape[1], dtype=torch.int32,
                        device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "length": length}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Tensor]:
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def cache_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "length": ("batch",),
    }


def decode_step(params: Params, cfg: ModelConfig, token: Tensor,
                cache: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """token (B,) int; cache k/v (L, B, T, KV, hd) + length (B,).

    Returns (logits (B, V) fp32, cache). The new token's K/V is written
    into ``cache["k"]`` / ``cache["v"]`` in place; ``length`` is a new tensor.
    """
    x = embed(token[:, None], params["embed"], scale=cfg.embed_scale)
    position = cache["length"]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        hn = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
        attn_out, _ = A.decode_self_attention(lp, hn, cfg, cache["k"][i], cache["v"][i],
                                              position, cfg.attn_window)
        x = x + attn_out
        x = x + _ffn(lp, rms_norm(x, lp["norm_mlp"], cfg.norm_eps), cfg)
    logits = _head(params, cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "length": cache["length"] + 1}


def decode_step_paged(params: Params, cfg: ModelConfig, token: Tensor,
                      pool: Tensor, block_tables: Tensor, lengths: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """One batched decode step directly on the FlowKV pool (zero-gather).

    token (B,) int; pool (nb, L, 2, payload); block_tables (B, W) int32;
    lengths (B,) int32 = tokens already cached per request — the new token's
    write position. Returns (logits (B, V) fp32, pool), the pool updated IN
    PLACE: every layer's attention reads the pool through the paged kernel
    (K3, one launch per layer, the in-flight token merged from its softmax
    state), and the batch's new K/V for all layers lands with one fused K1
    append launch after the layer stack.
    """
    from repro_torch.kernels.kv_gather import kv_append_tokens

    x = embed(token[:, None], params["embed"], scale=cfg.embed_scale)
    ks, vs = [], []
    for i in range(pool.shape[1]):
        lp = layer_params(params, i)
        hn = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
        attn_out, (k_new, v_new) = A.decode_paged_self_attention(
            lp, hn, cfg, pool, block_tables, lengths, layer=i)
        x = x + attn_out
        x = x + _ffn(lp, rms_norm(x, lp["norm_mlp"], cfg.norm_eps), cfg)
        ks.append(k_new)
        vs.append(v_new)
    kv_append_tokens(pool, block_tables, lengths, torch.stack(ks), torch.stack(vs),
                     block_size=cfg.block_size)
    return _head(params, cfg, x), pool


# ---------------------------------------------------------------------------
# Convenience
# ---------------------------------------------------------------------------
def greedy_generate(params: Params, cfg: ModelConfig, prompt: Tensor,
                    max_new_tokens: int, max_len: Optional[int] = None) -> Tensor:
    """Reference autoregressive generation on the dense cache (B, new) int32."""
    b, s = prompt.shape
    max_len = max_len or (s + max_new_tokens)
    logits, pre = prefill(params, cfg, prompt)
    cache = init_cache(cfg, b, max_len, device=prompt.device)
    cache["k"][:, :, :s] = pre["k"]
    cache["v"][:, :, :s] = pre["v"]
    cache["length"] = torch.full((b,), s, dtype=torch.int32, device=prompt.device)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
