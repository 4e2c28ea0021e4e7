"""Uniform model API over the four families. Port of ``repro/models/api.py``.

``get_model(cfg)`` returns a :class:`Model` whose members close over the
config — the protocol the serving engine talks to::

    init(seed, device) -> params
    prefill(params, batch) -> (logits, cache)
    decode(params, token, cache) -> (logits, cache)
    init_cache(batch, max_len, device=) -> cache
    decode_paged(params, token, pool, block_tables, lengths) -> (logits, pool)
    prefill_suffix(params, batch, prefix_k, prefix_v) -> (logits, cache)

The state families (ssm, hybrid, encdec) have neither of the last two, as
in the reference: their caches are not paged.
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
    prefill: Callable[[Params, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    decode: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    init_cache: Callable[..., Dict[str, torch.Tensor]]
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
        return _simple_model(cfg, griffin)
    if cfg.family == "encdec":
        return _encdec_model(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def _transformer_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda seed=0, device=None: transformer.init_params(cfg, seed, device),
        prefill=lambda p, b: transformer.prefill(p, cfg, b["tokens"],
                                                 b.get("frontend_embeds")),
        decode=lambda p, tok, cache: transformer.decode_step(p, cfg, tok, cache),
        init_cache=lambda batch, max_len, **kw: transformer.init_cache(cfg, batch, max_len, **kw),
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
        prefill=lambda p, b: mod.prefill(p, cfg, b["tokens"]),
        decode=lambda p, tok, cache: mod.decode_step(p, cfg, tok, cache),
        init_cache=lambda batch, max_len=0, **kw: mod.init_cache(cfg, batch, max_len, **kw),
    )


def _encdec_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda seed=0, device=None: encdec.init_params(cfg, seed, device),
        prefill=lambda p, b: encdec.prefill(p, cfg, b),
        decode=lambda p, tok, cache: encdec.decode_step(p, cfg, tok, cache),
        init_cache=lambda batch, max_len, enc_len=4096, **kw: encdec.init_cache(
            cfg, batch, max_len, enc_len, **kw),
    )
