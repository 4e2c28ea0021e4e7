"""mamba2-370m [ssm] — 48L d_model=1024 attn-free, ssm_state=128, SSD.
[arXiv:2405.21060; unverified]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "mamba2-370m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm", num_layers=48, d_model=1024,
        vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
        ssm_conv=4, ssm_chunk=256, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm", num_layers=2, d_model=64,
        vocab_size=128, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
        ssm_conv=4, ssm_chunk=8, dtype=torch.float32,
    )
