"""llama31-70b — the paper's large measurement model (Table 2):
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256."""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "llama31-70b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=28672,
        vocab_size=128256, rope_theta=500000.0, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=128, dtype=torch.float32,
    )
