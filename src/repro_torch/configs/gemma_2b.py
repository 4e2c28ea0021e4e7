"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256, sqrt(d) embedding scale. [arXiv:2403.08295; hf]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "gemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=18, d_model=2048,
        num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
        activation="gelu", vocab_size=256000, embed_scale=True,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        activation="gelu", vocab_size=128, embed_scale=True, dtype=torch.float32,
    )
