"""Config registry of the PyTorch port (reference: ``repro/configs``):
every architecture of the reference, each in a module of the same name."""
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

ALL_ARCHS: List[str] = list(_REGISTRY)


def _module(arch: str):
    if arch not in _REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
