"""Uniform model API over the four families. Port of ``repro/models/api.py``.

``get_model(cfg)`` returns a :class:`Model` whose members close over the
config — the protocol the serving engine talks to::

    init(seed, device) -> params
    param_axes() -> logical-axis tree (same structure as params)
    loss(params, batch) -> scalar (training; ``distributed/steps.py``)
    prefill(params, batch) -> (logits, cache)
    decode(params, token, cache) -> (logits, cache)
    init_cache(batch, max_len, device=) -> cache
    cache_axes() -> logical-axis tree for the cache
    decode_paged(params, token, pool, block_tables, lengths) -> (logits, pool)
    prefill_suffix(params, batch, prefix_k, prefix_v) -> (logits, cache)

The state families (ssm, hybrid, encdec) have neither of the last two, as
in the reference: their caches are not paged. ``granitemoehybrid`` pages
its attention K/V and keeps its Mamba-2 state in slots: it has
``decode_paged`` (with the slots) and ``prefill_chunk`` instead of
``prefill_suffix``. ``input_specs`` gives the
dry-run's batch shapes as ``meta`` tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import encdec, granite_hybrid, griffin, mamba2, moe, transformer
from repro_torch.models.common import ModelConfig

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]
    param_axes: Callable[[], Params]
    loss: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    prefill: Callable[[Params, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    decode: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    init_cache: Callable[..., Dict[str, torch.Tensor]]
    cache_axes: Callable[[], Dict[str, Tuple[Optional[str], ...]]]
    # Zero-gather decode; None means the engine must use the dense bridge
    # (the paged kernel has no local-window mask).
    decode_paged: Optional[Callable[..., Tuple[torch.Tensor, torch.Tensor]]] = None
    # Whether decode_paged's forward has static shapes and reads nothing on
    # the host, so that a CUDA engine can capture it as a graph.
    decode_paged_static: bool = False
    # Suffix-only prefill for prefix hits and prefill chunks; None means the
    # engine must run the full prefill (windowed attention).
    prefill_suffix: Optional[Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]] = None
    # A family whose request state is paged K/V beside a state slot
    # (granitemoehybrid): one prefill chunk from the carried state,
    # prefill_chunk(params, tokens, prefix_k, prefix_v, conv, h) ->
    # (logits, {k, v}, conv, h); its decode_paged also takes
    # (slot_ids, slots) after the lengths.
    prefill_chunk: Optional[Callable[..., Tuple[Any, ...]]] = None


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return _transformer_model(cfg)
    if cfg.family == "ssm":
        return _simple_model(cfg, mamba2)
    if cfg.family == "hybrid":
        return dataclasses.replace(_simple_model(cfg, griffin),
                                   cache_axes=lambda: griffin.cache_axes(cfg))
    if cfg.family == "encdec":
        return _encdec_model(cfg)
    if cfg.family == "granitemoehybrid":
        return _granite_hybrid_model(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def _no_dense_decode(*a, **kw):
    raise ValueError("granitemoehybrid decodes through decode_paged (pages and state "
                     "slots); it has no dense-cache decode")


def _granite_hybrid_model(cfg: ModelConfig) -> Model:
    G = granite_hybrid
    return Model(
        cfg=cfg,
        init=lambda seed=0, device=None: G.init_params(cfg, seed, device),
        param_axes=lambda: G.param_axes(cfg),
        loss=lambda p, b: G.loss_fn(p, cfg, b),
        prefill=lambda p, b: G.prefill(p, cfg, b["tokens"]),
        decode=_no_dense_decode,
        init_cache=lambda batch, max_len, **kw: G.init_cache(cfg, batch, max_len, **kw),
        cache_axes=G.cache_axes,
        decode_paged=lambda p, tok, pool, bt, lens, slot_ids, slots: G.decode_step_paged(
            p, cfg, tok, pool, bt, lens, slot_ids, slots),
        decode_paged_static=True,
        prefill_chunk=lambda p, tokens, pk, pv, conv, h: G.prefill_chunk(
            p, cfg, tokens, pk, pv, conv, h),
    )


def _transformer_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda seed=0, device=None: transformer.init_params(cfg, seed, device),
        param_axes=lambda: transformer.param_axes(cfg),
        loss=lambda p, b: transformer.loss_fn(p, cfg, b),
        prefill=lambda p, b: transformer.prefill(p, cfg, b["tokens"],
                                                 b.get("frontend_embeds")),
        decode=lambda p, tok, cache: transformer.decode_step(p, cfg, tok, cache),
        init_cache=lambda batch, max_len, **kw: transformer.init_cache(cfg, batch, max_len, **kw),
        cache_axes=transformer.cache_axes,
        decode_paged=None if cfg.attn_window > 0 else (
            lambda p, tok, pool, bt, lens: transformer.decode_step_paged(
                p, cfg, tok, pool, bt, lens)),
        decode_paged_static=cfg.attn_window == 0 and not moe.host_routed(cfg),
        prefill_suffix=None if cfg.attn_window > 0 else (
            lambda p, b, pk, pv: transformer.prefill_suffix(p, cfg, b["tokens"], pk, pv)),
    )


def _simple_model(cfg: ModelConfig, mod) -> Model:
    return Model(
        cfg=cfg,
        init=lambda seed=0, device=None: mod.init_params(cfg, seed, device),
        param_axes=lambda: mod.param_axes(cfg),
        loss=lambda p, b: mod.loss_fn(p, cfg, b),
        prefill=lambda p, b: mod.prefill(p, cfg, b["tokens"]),
        decode=lambda p, tok, cache: mod.decode_step(p, cfg, tok, cache),
        init_cache=lambda batch, max_len=0, **kw: mod.init_cache(cfg, batch, max_len, **kw),
        cache_axes=mod.cache_axes,
    )


def _encdec_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda seed=0, device=None: encdec.init_params(cfg, seed, device),
        param_axes=lambda: encdec.param_axes(cfg),
        loss=lambda p, b: encdec.loss_fn(p, cfg, b),
        prefill=lambda p, b: encdec.prefill(p, cfg, b),
        decode=lambda p, tok, cache: encdec.decode_step(p, cfg, tok, cache),
        init_cache=lambda batch, max_len, enc_len=4096, **kw: encdec.init_cache(
            cfg, batch, max_len, enc_len, **kw),
        cache_axes=encdec.cache_axes,
    )


# ---------------------------------------------------------------------------
# Dry-run input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------
ENC_MEMORY_LEN = 4096   # stub encoder length for enc-dec decode cells


def input_specs(cfg: ModelConfig, shape_kind: str, seq: int, batch: int
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (specs, logical_axes) for one dry-run cell, with the
    reference's tree structure, shapes, dtypes and axes.

    ``specs`` mirrors the step function's batch argument; every leaf is a
    tensor on the ``meta`` device (the reference's ``ShapeDtypeStruct``).
    """
    def S(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    act = cfg.dtype

    if shape_kind == "train":
        if cfg.family == "encdec":
            dec = max(seq // 8, 128)
            specs = {"frames": S((batch, seq, cfg.d_model), act),
                     "tokens": S((batch, dec), i32),
                     "labels": S((batch, dec), i32)}
            axes = {"frames": ("batch", "seq", "embed"),
                    "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        elif cfg.frontend != "none":
            f = cfg.frontend_tokens
            specs = {"tokens": S((batch, seq - f), i32),
                     "labels": S((batch, seq), i32),
                     "frontend_embeds": S((batch, f, cfg.d_model), act)}
            axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                    "frontend_embeds": ("batch", "seq", "embed")}
        else:
            specs = {"tokens": S((batch, seq), i32), "labels": S((batch, seq), i32)}
            axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        return specs, axes

    if shape_kind == "prefill":
        if cfg.family == "encdec":
            specs = {"frames": S((batch, seq, cfg.d_model), act),
                     "tokens": S((batch, 1), i32)}
            axes = {"frames": ("batch", "seq", "embed"), "tokens": ("batch", "seq")}
        elif cfg.frontend != "none":
            f = cfg.frontend_tokens
            specs = {"tokens": S((batch, seq - f), i32),
                     "frontend_embeds": S((batch, f, cfg.d_model), act)}
            axes = {"tokens": ("batch", "seq"),
                    "frontend_embeds": ("batch", "seq", "embed")}
        else:
            specs = {"tokens": S((batch, seq), i32)}
            axes = {"tokens": ("batch", "seq")}
        return specs, axes

    if shape_kind == "decode":
        model = get_model(cfg)
        if cfg.family == "encdec":
            cache = model.init_cache(batch, seq, enc_len=ENC_MEMORY_LEN, device="meta")
        else:
            cache = model.init_cache(batch, seq, device="meta")
        specs = {"token": S((batch,), i32), "cache": cache}
        axes = {"token": ("batch",), "cache": model.cache_axes()}
        return specs, axes

    raise ValueError(f"unknown shape kind {shape_kind!r}")
