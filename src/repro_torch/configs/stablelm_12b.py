"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-12b; hf]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "stablelm-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=40, d_model=5120,
        num_heads=32, num_kv_heads=8, head_dim=160, d_ff=13824,
        vocab_size=100352, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=128, dtype=torch.float32,
    )
