"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling (stub patch embeddings, 2880 tokens).
[hf:llava-hf/llava-v1.6-34b-hf; unverified]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "llava-next-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm", num_layers=60, d_model=7168,
        num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480,
        vocab_size=64000, frontend="vision", frontend_tokens=2880,
        rope_theta=5000000.0, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=128, frontend="vision", frontend_tokens=16, dtype=torch.float32,
    )
