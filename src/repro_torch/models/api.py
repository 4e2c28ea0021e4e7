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
in the reference: their caches are not paged. ``input_specs`` (the
dry-run's batch shapes) waits for ROADMAP item 12b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import encdec, griffin, mamba2, transformer
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
    # Suffix-only prefill for prefix hits and prefill chunks; None means the
    # engine must run the full prefill (windowed attention).
    prefill_suffix: Optional[Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]] = None


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
    raise ValueError(f"unknown family {cfg.family!r}")


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
