"""A configuration file as the port's ``ModelConfig`` and as closed-form
work: every preset of the port read back from a file's ``family`` and
``port``, qwen3-1.7b's file read as before, its work counts pinned, the
counted weights equal to the built ones, a file counted otherwise than the
port builds it refused, a two-layer Mamba-2 / attention pattern and
granite-4.0-h-small counted by hand, and unknown ``port`` keys refused."""
import dataclasses
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from flowbench import flops, harness, rehearsal  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402

QWEN = json.loads((ROOT / "flowbench" / "configs" / "qwen3-1.7b.json").read_text())


def as_file(cfg: ModelConfig) -> dict:
    """A configuration file naming ``cfg`` by ``family`` and ``port``, as JSON
    holds it: the dtype by name, tuples as lists."""
    def plain(v):
        if isinstance(v, torch.dtype):
            return str(v).removeprefix("torch.")
        return list(v) if isinstance(v, tuple) else v
    port = {f.name: plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
            if f.name not in ("name", "family")}
    return json.loads(json.dumps({"name": cfg.name, "family": cfg.family, "port": port}))


@pytest.mark.parametrize("preset", [get_config, get_smoke_config], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_preset_round_trips_through_a_file(arch, preset):
    cfg = preset(arch)
    assert harness.port_config(as_file(cfg)) == cfg


def test_a_port_object_may_name_only_what_differs_from_the_defaults():
    f = {"name": "m", "family": "ssm",
         "port": {"num_layers": 2, "d_model": 64, "vocab_size": 128, "ssm_state": 16,
                  "ssm_head_dim": 16, "dtype": "float32"}}
    assert harness.port_config(f) == ModelConfig(
        name="m", family="ssm", num_layers=2, d_model=64, vocab_size=128, ssm_state=16,
        ssm_head_dim=16, dtype=torch.float32)


def test_qwen3_file_reads_as_the_parents_model_config():
    assert harness.port_config(QWEN) == ModelConfig(
        name="qwen3-1.7b", family="dense", num_layers=28, d_model=2048, vocab_size=151936,
        num_heads=16, num_kv_heads=8, head_dim=128, qk_norm=True, rope_theta=1000000.0,
        d_ff=6144, dtype=torch.bfloat16, block_size=32, tie_embeddings=True,
        norm_eps=1e-06, flash_threshold=1024)
    # and the file's own keys give what the port's preset gives at these widths
    assert harness.port_config(QWEN) == get_config("qwen3-1.7b")


@pytest.mark.parametrize("bad,match", [
    ({"port": {"num_layers": 2, "d_model": 64, "vocab_size": 128, "hidden": 3}},
     "hidden"),
    ({"port": {"num_layers": 2, "d_model": 64, "vocab_size": 128}, "family": "wavenet"},
     "wavenet"),
    ({"family": "ssm"}, "port"),
])
def test_a_file_with_an_unknown_port_key_or_family_is_refused(bad, match):
    base = dict(QWEN, family="ssm") if "port" in bad else dict(QWEN)
    with pytest.raises(ValueError, match=match):
        harness.port_config(dict(base, **bad))


# a Mamba-2 model at small widths, described both ways: the port object the
# program builds and the published keys flops.py counts
MAMBA = {"name": "mamba", "family": "ssm",
         "port": {"num_layers": 2, "d_model": 64, "vocab_size": 128, "ssm_state": 16,
                  "ssm_head_dim": 16, "ssm_chunk": 8, "dtype": "float32"},
         "hidden_size": 64, "num_hidden_layers": 2, "layer_types": ["mamba", "mamba"],
         "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16, "mamba_d_conv": 4,
         "mamba_chunk_size": 8, "ffn": "none", "vocab_size": 128, "dtype": "float32",
         "flash_threshold": 1024}


def _built_weights_active(mc, params) -> int:
    """Weights a token multiplies through, summed over the built layers: every
    matrix of a layer (conv taps, norms, gains and decays left out, as
    flops.py leaves them out), an expert's weights at top-k of E."""
    n = 0
    for k, v in params["layers"].items():
        if v.dim() < 3 or k.startswith("conv"):
            continue
        per = v[0].numel()
        n += mc.num_layers * (per * mc.top_k // mc.num_experts if k.startswith("moe_w_")
                              else per)
    return n


@pytest.mark.parametrize("file", [rehearsal.TINY_CONFIG, rehearsal.TINY_MOE, MAMBA],
                         ids=["dense", "moe", "ssm"])
def test_the_counted_weights_are_the_weights_the_port_builds(file):
    mc = harness.port_config(file)
    params = get_model(mc).init(0, "cpu")
    assert flops.body_params_active(file) == _built_weights_active(mc, params)
    assert flops.kv_bytes_per_token(file) == mc.kv_bytes_per_token()


@pytest.mark.parametrize("change,key", [
    ({"layer_types": ["mamba", "attention"]}, "layer_types"),
    ({"mamba_d_state": 32}, "mamba_d_state"),
    ({"mamba_n_groups": 2}, "mamba_n_groups"),
    ({"ffn": "gated_mlp", "intermediate_size": 96}, "ffn"),
    ({"shared_intermediate_size": 64}, "shared_intermediate_size"),
    ({"hidden_size": 128}, "hidden_size"),
])
def test_a_file_counted_otherwise_than_the_port_builds_it_is_refused(change, key):
    with pytest.raises(ValueError, match=f"another model.*'{key}'"):
        harness.port_config(dict(MAMBA, **change))


@pytest.mark.parametrize("change,key", [
    ({"ffn": "moe_topk", "num_local_experts": 4, "num_experts_per_tok": 2}, "ffn"),
    ({"head_dim": 32}, "head_dim"),
    ({"layer_types": ["attention", "mamba"]}, "layer_types"),
    ({"shared_intermediate_size": 64}, "shared_intermediate_size"),
])
def test_a_decoder_file_counted_otherwise_than_built_is_refused(change, key):
    tiny = rehearsal.TINY_CONFIG
    built = dict(tiny, **as_file(harness.port_config(tiny)))
    assert harness.port_config(built) == harness.port_config(tiny)
    with pytest.raises(ValueError, match=f"another model.*'{key}'"):
        harness.port_config(dict(built, **change))


def test_a_family_module_found_by_name_describes_a_family_the_harness_does_not_know(
        tmp_path, monkeypatch):
    # a hybrid file counted as two attention layers: the port's hybrid is
    # Griffin's, but a families/hybrid.py may say how it is to be counted
    f = dict(rehearsal.TINY_CONFIG, family="hybrid",
             port={"num_layers": 2, "d_model": 64, "vocab_size": 128, "num_heads": 4,
                   "num_kv_heads": 2, "head_dim": 16, "d_ff": 96, "dtype": "float32",
                   "layer_pattern": ["rec", "rec", "attn"]})
    with pytest.raises(ValueError, match="no count for the 'hybrid' family"):
        harness.port_config(f)
    monkeypatch.setattr(harness, "FAMILIES", tmp_path)
    (tmp_path / "hybrid.py").write_text(
        "def counted_keys(mc):\n"
        "    return {'layer_types': ['attention'] * mc.num_layers, 'head_dim': mc.head_dim}\n")
    assert harness.port_config(f).family == "hybrid"
    with pytest.raises(ValueError, match="another model.*'head_dim'"):
        harness.port_config(dict(f, head_dim=32))


def test_a_file_without_counted_keys_builds_without_the_check():
    # the round trip's files carry no ffn: they build, and flops.py is not asked
    assert harness.port_config({k: MAMBA[k] for k in ("name", "family", "port")}) == \
        harness.port_config(MAMBA)


# qwen3-1.7b's counts as the parent's flops.py gave them, digit for digit
QWEN_CHUNKS = [((0, 4096, False), 13469487202304.0), ((4096, 4096, True), 17318400229376.0),
               ((8192, 904, True), 4341099790336.0), ((0, 1024, True), 3007216877568.0),
               ((12288, 4096, False), 25014359293952.0)]
QWEN_DECODES = [(0, 3441131520.0), (1, 3441360896.0), (5000, 4588011520.0),
                (16383, 7198998528.0)]
QWEN_K4 = [((0, 2048), {"flops": 481271218176.0, "bytes": 704643072.0}),
           ((2048, 2048), {"flops": 1443343892480.0, "bytes": 939524096.0}),
           ((1024, 32), {"flops": 7637303296.0, "bytes": 128450560.0}), ((0, 1024), None)]


def test_qwen3_work_counts_are_the_parents():
    for args, want in QWEN_CHUNKS:
        assert flops.chunk_flops(QWEN, *args) == want
    for ctx, want in QWEN_DECODES:
        assert flops.decode_flops(QWEN, ctx) == want
    for args, want in QWEN_K4:
        assert flops.k4_chunk_cost(QWEN, *args) == want
    assert flops.kv_bytes_per_token(QWEN) == 114_688
    assert flops.state_bytes_per_request(QWEN) == 0


# two layers, Mamba-2 then attention, at small widths
PAIR = {"hidden_size": 64, "num_hidden_layers": 2, "layer_types": ["mamba", "attention"],
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16, "mamba_n_groups": 1,
        "mamba_d_conv": 4, "mamba_chunk_size": 8, "ffn": "gated_mlp",
        "intermediate_size": 96, "vocab_size": 128, "dtype": "float32",
        "flash_threshold": 40}


def test_a_mamba_attention_pair_counted_by_hand():
    # attention 2*64*4*16 + 2*64*2*16; mamba in 64*(2*8*16 + 2*16 + 8), out 8*16*64;
    # the gated MLP 3*64*96 on both layers
    assert flops.layer_params_active(PAIR, "attention") == 12288 + 18432
    assert flops.layer_params_active(PAIR, "mamba") == 18944 + 8192 + 18432
    assert flops.body_params_active(PAIR) == 76288
    assert flops.attn_pair_flops(PAIR) == 4 * 4 * 16
    # 20 prompt tokens after 5: SSD chunks of 8, 8, 4 (36 + 36 + 10 causal
    # pairs), 4*H*P*N a token and 2*(G*N + H*P) a pair; attention 20*5 + 210 pairs
    ssd = 4 * 8 * 16 * 16 * 20 + 2 * (16 + 128) * 82
    assert flops.ssd_chunk_flops(PAIR, 20) == ssd == 187456
    prompt = 2 * 76288 * 20 + 256 * 310 + ssd
    assert flops.chunk_flops(PAIR, 5, 20, False) == prompt
    assert flops.chunk_flops(PAIR, 5, 20, True) == prompt + 2 * 64 * 128
    # a decode token over 30 cached: the state update and read, 4*H*P*N
    assert flops.decode_flops(PAIR, 30) == 2 * 76288 + 256 * 31 + 2 * 64 * 128 + 8192
    # K/V of the one attention layer; the state: fp32 h and a 3-token conv tail
    assert flops.kv_bytes_per_token(PAIR) == 2 * 2 * 16 * 4
    assert flops.state_bytes_per_request(PAIR) == 4 * 8 * 16 * 16 + 3 * (128 + 32) * 4
    assert flops.k4_chunk_cost(PAIR, 0, 40) is None
    assert flops.k4_chunk_cost(PAIR, 30, 20) == {"flops": 256 * 810,
                                                 "bytes": 4 * 16 * (2 * 20 * 4 + 2 * 50 * 2)}


def test_layer_types_must_be_known_and_match_the_depth():
    with pytest.raises(ValueError, match="unknown layer types"):
        flops.body_params_active(dict(PAIR, layer_types=["mamba", "rwkv"]))
    with pytest.raises(ValueError, match="lists 1 layers"):
        flops.body_params_active(dict(PAIR, layer_types=["mamba"]))


# granite-4.0-h-small's published config (the catalog's granitemoehybrid keys),
# with a port object of today's ModelConfig fields. flops.py counts the file;
# the port's "hybrid" family is Griffin's (RG-LRU blocks, no experts, no shared
# expert), so port_config refuses to build it as this model
GRANITE_H = {
    "name": "granite-4.0-h-small", "family": "hybrid",
    "hidden_size": 4096, "num_hidden_layers": 40, "num_attention_heads": 32,
    "num_key_value_heads": 8, "intermediate_size": 768, "shared_intermediate_size": 1536,
    "num_local_experts": 72, "num_experts_per_tok": 10, "ffn": "moe_topk",
    "layer_types": ["attention" if i in (5, 15, 25, 35) else "mamba" for i in range(40)],
    "mamba_n_heads": 128, "mamba_d_head": 64, "mamba_d_state": 128, "mamba_n_groups": 1,
    "mamba_d_conv": 4, "mamba_chunk_size": 256, "mamba_expand": 2,
    "vocab_size": 100352, "dtype": "bfloat16", "flash_threshold": 1024,
    "port": {"num_layers": 40, "d_model": 4096, "vocab_size": 100352, "num_heads": 32,
             "num_kv_heads": 8, "head_dim": 128, "num_experts": 72, "top_k": 10,
             "moe_d_ff": 768, "ssm_state": 128, "ssm_head_dim": 64, "ssm_conv": 4,
             "ssm_chunk": 256, "norm_eps": 1e-05, "dtype": "bfloat16",
             "layer_pattern": ["rec"] * 5 + ["attn"] + ["rec"] * 4},
}


def test_granite_h_small_is_counted_from_its_file_and_not_built_as_another_model():
    with pytest.raises(ValueError, match="no count for the 'hybrid' family"):
        harness.port_config(GRANITE_H)
    moe = 4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536
    mamba = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 2 * 4096 * 32 * 128 + 2 * 4096 * 8 * 128
    assert flops.body_params_active(GRANITE_H) == 36 * (mamba + moe) + 4 * (attn + moe) \
        == 8_389_918_720
    assert flops.kv_bytes_per_token(GRANITE_H) == 16_384
    # 36 layers of fp32 h (128 x 64 x 128) and a 3-token bf16 conv tail
    assert flops.state_bytes_per_request(GRANITE_H) == 36 * (4 * 128 * 64 * 128
                                                             + 3 * (8192 + 256) * 2)
    assert flops.decode_flops(GRANITE_H, 0) == (2.0 * 8_389_918_720 + 4 * 4 * 32 * 128
                                                + 2 * 4096 * 100352
                                                + 4 * 36 * 128 * 64 * 128)
