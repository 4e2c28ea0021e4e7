"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) expert_ff=512
vocab=49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "granite-moe-1b-a400m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=8, head_dim=64, d_ff=0, moe_d_ff=512,
        num_experts=32, top_k=8, vocab_size=49155, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=0, moe_d_ff=32,
        num_experts=4, top_k=2, vocab_size=128, dtype=torch.float32,
    )
