"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) expert_ff=8192
vocab=202048, MoE 16 experts top-1, early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", num_layers=48, d_model=5120,
        num_heads=40, num_kv_heads=8, head_dim=128, d_ff=0, moe_d_ff=8192,
        num_experts=16, top_k=1, vocab_size=202048, dtype=torch.bfloat16,
        rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=0, moe_d_ff=32,
        num_experts=4, top_k=1, vocab_size=128, dtype=torch.float32,
    )
