"""The training path on the card (``gpu`` marker; skipped without an sm_90
device): one float32 train step of every family at smoke width on the card
against the same step on the CPU, one full-width qwen3-1.7b layer's loss
and gradients on the card against the CPU, and K4 / K3 refusing a CUDA
input that requires grad. Imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_train_kernels.py

Bars (chip_smoke's ``train_parity``): the loss within 1e-5 relative, each
gradient leaf within 1e-3 of that leaf's max |g|, the updated master within
1e-6 absolute (Adam's eps at 1e-3 for that comparison: at 1e-8 the first
step is lr * sign(g), and an element whose gradient sits at the fp32 noise
floor flips). The smoke configs' attention is tempered by sqrt(H / d), as
the CPU tests do (``dense_init`` reads the heads axis as the fan-in).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import steps as ST  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill_op  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402

LOSS_REL, GRAD_REL, MASTER_ABS = 1e-5, 1e-3, 1e-6
OPT_CFG = OPT.AdamWConfig(lr=1e-4, eps=1e-3, warmup_steps=1)
ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m", "llava-next-34b", "mamba2-370m",
         "recurrentgemma-2b", "seamless-m4t-large-v2"]


def _require_sm90():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (H100)")


@pytest.fixture(autouse=True)
def _no_tf32():
    """fp32 GEMMs on the card in full fp32, as chip_smoke runs them."""
    if not torch.cuda.is_available():
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _tempered(tree, f):
    for k, v in tree.items():
        if isinstance(v, dict):
            _tempered(v, f)
        elif k in ("wq", "wk", "x_wq", "x_wk"):
            v.mul_(f)


def _batch(cfg, s=24, seed=0):
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, s)))
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.randn(2, 32, cfg.d_model).astype(np.float32))
    if cfg.frontend_tokens:
        batch["frontend_embeds"] = torch.from_numpy(
            rng.randn(2, cfg.frontend_tokens, cfg.d_model).astype(np.float32))
    return batch


def _step(model, state, batch, dev):
    loss, grads = ST.loss_and_grads(model, state["master"],
                                    {k: v.to(dev) for k, v in batch.items()})
    state, _ = OPT.apply_updates(state, grads, OPT_CFG, compute_dtype=model.cfg.dtype)
    return float(loss), [g.cpu() for g in tree_leaves(grads)], \
        [w.cpu() for w in tree_leaves(state["master"])]


def _hold(card, cpu):
    (lg, gg, mg), (lc, gc, mc) = card, cpu
    assert abs(lg - lc) <= LOSS_REL * abs(lc), (lg, lc)
    for i, (a, b) in enumerate(zip(gg, gc)):
        assert float((a - b).abs().max()) <= GRAD_REL * float(b.abs().max()), i
    for i, (a, b) in enumerate(zip(mg, mc)):
        assert float((a - b).abs().max()) <= MASTER_ABS, i


@pytest.mark.gpu
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_card_matches_cpu(arch, flash):
    """Smoke width; ``flash`` lowers flash_threshold below S so training's
    chunked flash (and the encoder's non-causal one) runs on the card."""
    _require_sm90()
    over = dict(flash_threshold=8, attn_q_chunk=8, attn_kv_chunk=16) if flash else {}
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = get_model(cfg)
    params = model.init(0, "cpu")
    if cfg.num_heads:
        _tempered(params, (cfg.num_heads / cfg.d_model) ** 0.5)
    cpu_state = OPT.init_state(params)
    card_state = tree_map(lambda t: t.to("cuda"), cpu_state)
    batch = _batch(cfg)
    before = (flash_prefill_op.launches, paged_decode_attention.launches)
    card = _step(model, card_state, batch, "cuda")
    assert (flash_prefill_op.launches, paged_decode_attention.launches) == before
    _hold(card, _step(model, cpu_state, batch, "cpu"))


@pytest.mark.gpu
def test_full_width_qwen3_layer_card_matches_cpu():
    """One full-width qwen3-1.7b layer (d 2048, 16/8 heads of 128, d_ff
    6144, vocab 151936), float32, 256 tokens: loss and every gradient."""
    _require_sm90()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=1, dtype=torch.float32)
    model = get_model(cfg)
    cpu_state = OPT.init_state(model.init(0, "cpu"))
    card_state = tree_map(lambda t: t.to("cuda"), cpu_state)
    batch = _batch(cfg, s=256)
    _hold(_step(model, card_state, batch, "cuda"), _step(model, cpu_state, batch, "cpu"))


@pytest.mark.gpu
def test_kernels_refuse_cuda_inputs_that_require_grad():
    _require_sm90()
    q = torch.randn(1, 64, 16, 128, device="cuda", requires_grad=True)
    k = torch.randn(1, 64, 8, 128, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_prefill_op(q, k, k)
    before = flash_prefill_op.launches
    with torch.no_grad():
        flash_prefill_op(q, k, k)
    assert flash_prefill_op.launches == before + 1
    pool = torch.zeros((4, 1, 2, 32 * 8 * 128), device="cuda")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    ln = torch.ones((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        paged_decode_attention(q[:, 0], pool, 0, bt, ln, block_size=32)
