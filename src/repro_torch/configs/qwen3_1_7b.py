"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm. [hf:Qwen/Qwen3-1.7B; hf]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=28, d_model=2048,
        num_heads=16, num_kv_heads=8, head_dim=128, d_ff=6144,
        qk_norm=True, vocab_size=151936, rope_theta=1000000.0,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        qk_norm=True, vocab_size=128, dtype=torch.float32,
    )
