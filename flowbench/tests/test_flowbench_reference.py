"""The frozen reference against the port's own forward on the port's smoke
configurations, on the CPU. The test imports both; the reference imports
nothing of the port."""
import ast
import dataclasses
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from flowbench import check, harness  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

REF_DIR = ROOT / "flowbench" / "reference"
ref = harness.load_module(REF_DIR / "decoder.py", "flowbench_reference_decoder_test")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_file(pcfg) -> dict:
    """A port ModelConfig written as a flowbench configuration file."""
    moe = pcfg.family == "moe"
    return {"name": pcfg.name, "reference": "decoder", "hidden_size": pcfg.d_model,
            "intermediate_size": pcfg.moe_d_ff if moe else pcfg.d_ff,
            "num_hidden_layers": pcfg.num_layers, "num_attention_heads": pcfg.num_heads,
            "num_key_value_heads": pcfg.num_kv_heads, "head_dim": pcfg.head_dim,
            "vocab_size": pcfg.vocab_size, "rope_theta": pcfg.rope_theta,
            "rms_norm_eps": pcfg.norm_eps, "tie_word_embeddings": pcfg.tie_embeddings,
            "qk_norm": pcfg.qk_norm, "ffn": "moe_topk" if moe else "gated_mlp",
            "num_local_experts": pcfg.num_experts, "num_experts_per_tok": pcfg.top_k,
            "dtype": "float32", "block_size": pcfg.block_size,
            "flash_threshold": pcfg.flash_threshold,
            "attn_temper": {"wq": 0.5, "wk": 0.5} if moe else {}}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_reference_matches_the_ports_forward(arch):
    pcfg = get_smoke_config(arch)
    cfg = _as_file(pcfg)
    assert harness.port_config(cfg) == dataclasses.replace(
        pcfg, name=cfg["name"], flash_threshold=cfg["flash_threshold"])
    params = ref.make_weights(cfg, 2**31 + 77, "cpu")
    tokens = torch.randint(0, pcfg.vocab_size, (1, 40), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _ = transformer.forward_train(params, pcfg, tokens)
    got = ref.logits_at(params, cfg, tokens[0].tolist(), range(40))
    assert torch.allclose(got, want[0], atol=2e-5, rtol=1e-5), \
        float((got - want[0]).abs().max())
    # the control rounds every linear layer to fp8: other logits, same shape
    ctrl = ref.logits_at(params, cfg, tokens[0].tolist(), range(40), quant="fp8")
    assert 1e-3 < float((ctrl - got).abs().max()) < 0.5 * float(got.abs().max())
    # the reference's own greedy tokens lie 0 below its best
    prompt, out = tokens[0].tolist()[:33], []
    for _ in range(8):
        seq = prompt + out
        out.append(int(ref.logits_at(params, cfg, seq, [len(seq) - 1]).argmax()))
    gap, cgap = check.gaps(ref, params, cfg, prompt, out, quant="fp8")
    assert len(gap) == 8 and float(abs(gap).max()) < 1e-5 and (cgap >= 0).all()


def test_weights_follow_the_seed_and_the_ports_layout():
    cfg = _as_file(get_smoke_config("granite-moe-1b-a400m"))
    a = ref.make_weights(cfg, 5, "cpu")
    b = ref.make_weights(cfg, 5, "cpu")
    c = ref.make_weights(cfg, 6, "cpu")
    assert all(torch.equal(a["layers"][k], b["layers"][k]) for k in a["layers"])
    assert not torch.equal(a["embed"], c["embed"])
    from repro_torch.models import api
    want = api.get_model(get_smoke_config("granite-moe-1b-a400m")).init(0, "cpu")
    assert {k: v.shape for k, v in a["layers"].items()} == \
        {k: v.shape for k, v in want["layers"].items()}
    assert a["embed"].shape == want["embed"].shape


def test_reference_imports_nothing_of_the_program():
    for path in REF_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add((node.module or "").split(".")[0])
        assert names <= {"__future__", "math", "typing", "torch"}, (path.name, names)
