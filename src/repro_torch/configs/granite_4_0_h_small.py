"""granite-4.0-h-small [granitemoehybrid] — 40L d_model=4096: 36 Mamba-2
(128 heads of 64, state 128, conv 4 with bias, SSD chunk 256) and 4 NoPE GQA
layers (32/8 of 128, score scale 1/128) at 5, 15, 25, 35; a MoE on every
layer (72 experts of 768, top-10, a shared expert of 1536); embeddings x 12,
residual branches x 0.22, logits / 16, tied, vocabulary 100,352.
[hf:ibm-granite/granite-4.0-h-small config.json]

As served here this device holds experts 0-17 of the 72 (a 4-way expert
share of one 4-card host); the router keeps its 72 outputs and its top-10.
The module is not in the registry (``configs.ALL_ARCHS``): the registry
lists the reference package's architectures, and the reference has no
model of this family."""
import torch

from repro_torch.models.common import ModelConfig

ARCH_ID = "granite-4.0-h-small"
PATTERN = ("mamba",) * 5 + ("attn",) + ("mamba",) * 4


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="granitemoehybrid", num_layers=40, d_model=4096,
        vocab_size=100352, num_heads=32, num_kv_heads=8, head_dim=128,
        use_rope=False, attn_scale=1.0 / 128, num_experts=72, top_k=10, moe_d_ff=768,
        moe_experts_held=18, shared_d_ff=1536, ssm_state=128, ssm_expand=2,
        ssm_head_dim=64, ssm_conv=4, ssm_chunk=256, ssm_conv_bias=True,
        layer_pattern=PATTERN, dtype=torch.bfloat16, block_size=32,
        embed_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0,
        norm_eps=1e-5, flash_threshold=1024, state_slots=40,
    )


def smoke_config() -> ModelConfig:
    """Four layers (Mamba-2, attention, twice), 8 experts of which 2 are
    held (a 4-way share), every multiplier as published."""
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="granitemoehybrid", num_layers=4, d_model=64,
        vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=16, use_rope=False,
        attn_scale=1.0 / 16, num_experts=8, top_k=3, moe_d_ff=32, moe_experts_held=2,
        shared_d_ff=48, ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
        ssm_chunk=8, ssm_conv_bias=True, layer_pattern=("mamba", "attn"),
        dtype=torch.float32, block_size=8, embed_multiplier=12.0,
        residual_multiplier=0.22, logits_scaling=16.0, norm_eps=1e-5,
        flash_threshold=40, state_slots=6,
    )
