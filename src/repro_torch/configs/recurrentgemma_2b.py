"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attn (window 2048), pattern 2 rec : 1 attn.
[arXiv:2402.19427; hf]"""
import torch
from repro_torch.models.common import ModelConfig

ARCH_ID = "recurrentgemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid", num_layers=26, d_model=2560,
        num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680,
        activation="gelu", attn_window=2048, layer_pattern=("rec", "rec", "attn"),
        lru_width=2560, vocab_size=256000, embed_scale=True, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid", num_layers=8, d_model=32,
        num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
        activation="gelu", attn_window=8, layer_pattern=("rec", "rec", "attn"),
        lru_width=32, vocab_size=128, embed_scale=True, dtype=torch.float32,
    )
