"""Config registry of the PyTorch port (reference: ``repro/configs``):
every architecture of the reference, each in a module of the same name,
and the dry-run's cells (``SHAPES``, ``shape_applicable``, ``list_cells``),
kept as the port's own copies."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

# arch id -> module name
_REGISTRY: Dict[str, str] = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "minitron-8b": "minitron_8b",
    "gemma-2b": "gemma_2b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-1.7b": "qwen3_1_7b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llava-next-34b": "llava_next_34b",
    # the paper's own measurement models (Tables 1-3)
    "llama31-8b": "llama31_8b",
    "llama31-70b": "llama31_70b",
}

ASSIGNED_ARCHS: List[str] = list(_REGISTRY)[:10]
ALL_ARCHS: List[str] = list(_REGISTRY)

# The assigned input-shape set: shape name -> (kind, seq_len, global_batch).
SHAPES = {
    "train_4k": ("train", 4096, 256),
    "prefill_32k": ("prefill", 32768, 32),
    "decode_32k": ("decode", 32768, 128),
    "long_500k": ("decode", 524288, 1),
}


def _module(arch: str):
    if arch not in _REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether a dry-run cell applies to this arch (DESIGN.md §4)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: pure full-attention arch has no sub-quadratic "
                       "mechanism at 524k context (DESIGN.md §4)")
    return True, ""


def list_cells(archs=None):
    """All (arch, shape_name) dry-run cells with applicability flags."""
    out = []
    for arch in (archs or ASSIGNED_ARCHS):
        cfg = get_config(arch)
        for shape_name in SHAPES:
            ok, why = shape_applicable(cfg, shape_name)
            out.append({"arch": arch, "shape": shape_name, "applicable": ok, "why": why})
    return out
