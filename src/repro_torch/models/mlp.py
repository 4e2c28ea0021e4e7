"""Gated MLPs (SwiGLU / GeGLU). Port of ``repro/models/mlp.py``."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig


def mlp_param_shapes(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def gated_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, activation: str) -> torch.Tensor:
    """SwiGLU/GeGLU: down( act(x @ gate) * (x @ up) )."""
    gate = _act(torch.matmul(x, p["w_gate"]), activation)
    up = torch.matmul(x, p["w_up"])
    return torch.matmul(gate * up, p["w_down"])
