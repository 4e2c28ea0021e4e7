"""How ``flops.py`` counts the port's ``granitemoehybrid`` family: Mamba-2
mixers (one group of B and C) and attention layers by the port's
``layer_pattern``, a top-k MoE of the experts held here (``num_local_experts``
is ``moe_experts_held``) beside a shared gated expert on every layer."""

import dataclasses
import json

KIND = {"mamba": "mamba", "attn": "attention"}


def counted_keys(mc) -> dict:
    return {"layer_types": [KIND[k] for k in mc.layer_kinds()],
            "num_attention_heads": mc.num_heads, "num_key_value_heads": mc.num_kv_heads,
            "head_dim": mc.head_dim, "mamba_n_heads": mc.ssm_heads,
            "mamba_d_head": mc.ssm_head_dim, "mamba_d_state": mc.ssm_state,
            "mamba_n_groups": 1, "mamba_d_conv": mc.ssm_conv,
            "mamba_chunk_size": mc.ssm_chunk, "ffn": "moe_topk",
            "intermediate_size": mc.moe_d_ff, "shared_intermediate_size": mc.shared_d_ff,
            "num_local_experts": mc.experts_held, "num_experts_per_tok": mc.top_k,
            "hidden_size": mc.d_model, "num_hidden_layers": mc.num_layers,
            "vocab_size": mc.vocab_size, "dtype": str(mc.dtype).removeprefix("torch.")}


def file_for(mc, embed_std: float = 0.02) -> dict:
    """A configuration file describing the port's ``ModelConfig`` ``mc`` of
    the family, as JSON holds it: the counted keys, the keys the reference
    reads (multipliers, the published expert count, ``init``) and the
    ``port`` object. The CPU tests build their small files with it."""
    port = {f.name: getattr(mc, f.name) for f in dataclasses.fields(mc)
            if f.name not in ("name", "family")}
    port["dtype"] = str(mc.dtype).removeprefix("torch.")
    return json.loads(json.dumps(dict(
        counted_keys(mc), name=mc.name, family=mc.family, port=port,
        reference="granitemoehybrid", published={"num_local_experts": mc.num_experts},
        embedding_multiplier=mc.embed_multiplier, residual_multiplier=mc.residual_multiplier,
        logits_scaling=mc.logits_scaling, attention_multiplier=mc.attn_scale,
        rms_norm_eps=mc.norm_eps, mamba_conv_bias=mc.ssm_conv_bias,
        flash_threshold=mc.flash_threshold, block_size=mc.block_size,
        init={"embed_std": embed_std})))
