"""Shared model substrate: config schema, RMSNorm, RoPE, embeddings.

Port of ``repro/models/common.py``. Params are plain dicts of tensors with
the reference's layouts: layer parameters stacked on a leading ``layers``
axis; the forward passes loop over that axis in Python where the reference
uses ``jax.lax.scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (0/None where attention-free)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_window: int = 0             # 0 = full causal; >0 = local windowed
    # mlp
    d_ff: int = 0
    activation: str = "silu"         # silu (swiglu) | gelu (geglu)
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64
    # hybrid (recurrentgemma)
    layer_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    # encoder-decoder
    num_encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub
    frontend: str = "none"
    frontend_tokens: int = 0
    # numerics / serving
    dtype: Any = torch.bfloat16      # a torch dtype (the reference types it with jnp)
    block_size: int = 32             # KV page size (tokens)
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma-style sqrt(d_model) input scale
    norm_eps: float = 1e-6
    # attention impl knobs
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    attn_wedge: bool = False         # exact-causal unrolled flash (models/flash.py)
    flash_threshold: int = 1024      # use chunked flash above this seq length
    moe_sparse_dispatch: bool = False
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25
    remat: str = "none"
    tp_reduce_bf16: bool = False

    # -- derived -------------------------------------------------------------
    def kv_bytes_per_token(self) -> int:
        """KV-cache bytes per token (what the P->D transfer moves)."""
        if self.family == "ssm":
            return 0
        return 2 * self.num_attention_layers() * self.num_kv_heads * \
            self.head_dim * self.dtype.itemsize

    def num_attention_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid" and self.layer_pattern:
            pat = self.layer_pattern
            full, rem = divmod(self.num_layers, len(pat))
            return full * sum(1 for t in pat if t == "attn") + sum(
                1 for t in pat[:rem] if t == "attn")
        return self.num_layers

    def num_params(self) -> int:
        """Analytic parameter count (dense / moe / vlm families)."""
        d, v = self.d_model, self.vocab_size
        attn = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim \
            + self.num_heads * self.head_dim * d
        if self.family == "moe":
            ff = self.num_experts * 3 * d * (self.moe_d_ff or self.d_ff) + d * self.num_experts
        else:
            ff = 3 * d * self.d_ff
        return v * d + self.num_layers * (attn + ff)

    def active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.num_params()
        d = self.d_model
        per_expert = 3 * d * (self.moe_d_ff or self.d_ff)
        return self.num_params() - self.num_layers * (self.num_experts - self.top_k) * per_expert


# ---------------------------------------------------------------------------
# Initializers (explicit torch.Generator; no claim to reproduce jax.random)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return out.mul_(s).to(dtype)


# ---------------------------------------------------------------------------
# Normalization / positional encodings
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool = False) -> torch.Tensor:
    out = table[tokens.long()]
    if scale:  # gemma-style sqrt(d) embedding scale, rounded to the table dtype
        out = out * torch.tensor(out.shape[-1] ** 0.5, dtype=out.dtype)
    return out


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, table.t()).float()
