"""Config registry of the PyTorch port (reference: ``repro/configs``).

Only the dense family is ported so far; every other arch id resolves to a
``NotImplementedError`` that names the ROADMAP item that brings its family.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

# arch id -> module name (dense family, ported)
_REGISTRY: Dict[str, str] = {
    "minitron-8b": "minitron_8b",
    "gemma-2b": "gemma_2b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-1.7b": "qwen3_1_7b",
    # the paper's own measurement models (Tables 1-3)
    "llama31-8b": "llama31_8b",
    "llama31-70b": "llama31_70b",
}

# arch id -> the ROADMAP.md queue-1 item that ports its family
_NOT_PORTED: Dict[str, str] = {
    "granite-moe-1b-a400m": "item 9 (MoE and TP/EP emulation)",
    "llama4-scout-17b-a16e": "item 9 (MoE and TP/EP emulation)",
    "mamba2-370m": "item 11 (state families)",
    "recurrentgemma-2b": "item 11 (state families)",
    "seamless-m4t-large-v2": "item 11 (state families)",
    "llava-next-34b": "item 9 (vlm frontend rides the MoE/TP slice)",
}

ALL_ARCHS: List[str] = list(_REGISTRY)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: see ROADMAP.md {_NOT_PORTED[arch]}")
    if arch not in _REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
