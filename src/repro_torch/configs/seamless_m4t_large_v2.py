"""seamless-m4t-large-v2 [audio enc-dec] — 24L enc + 24L dec, d_model=1024
16H (MHA kv=16) d_ff=8192 vocab=256206. Frontend = stub frame embeddings.
[arXiv:2308.11596; hf]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "seamless-m4t-large-v2"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec", num_layers=24, num_encoder_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64, d_ff=8192,
        cross_attention=True, frontend="audio", vocab_size=256206,
        dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="encdec", num_layers=2, num_encoder_layers=2,
        d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
        cross_attention=True, frontend="audio", vocab_size=128, dtype=torch.float32,
    )
