"""The state families' device path on the card (``gpu`` marker; skipped
without an sm_90 device): K4 in non-causal mode at seamless-m4t-large-v2's
encoder heads, and one mamba2 and one griffin layer's prefill on the card
against the same call on the CPU. Imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_state_kernels.py

Bars: K4 non-causal (16 / 16 heads, G = 1, hd 64, S = T = 1500 and 4096)
within 2e-5 of its plain version in float32, and in bfloat16 within half a
bf16 ulp (+1e-5) of the plain version on the upcast values and 3e-2 of it on
the bf16 values (the kernel tests' own limits), one non-causal launch
counted per call; the layers in float32 within 5e-4 (atol scaled by
max(1, max|cpu|)): the card and the CPU block their fp32 GEMMs
differently, and one product over K = 2560 may differ by ~K * 2^-24 =
1.5e-4 of its scale, three of them in a row in a griffin block.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill_op, flash_prefill_ref  # noqa: E402
from repro_torch.models import griffin as G  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
LAYER_TOL = 5e-4


def _require_sm90():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (H100)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1500, 4096])
def test_cuda_flash_prefill_noncausal_encoder_heads(t, dtype):
    _require_sm90()
    cfg = get_config("seamless-m4t-large-v2")
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert (h, kv, hd) == (16, 16, 64)
    g = torch.Generator(device="cuda").manual_seed(t)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)  # noqa: E731
    q, k, v = mk(1, t, h, hd), mk(1, t, kv, hd), mk(1, t, kv, hd)
    before = (flash_prefill_op.launches, flash_prefill_op.noncausal_launches)
    out = flash_prefill_op(q, k, v, causal=False)
    assert (flash_prefill_op.launches, flash_prefill_op.noncausal_launches) == \
        (before[0] + 1, before[1] + 1)
    same = flash_prefill_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = float((out.float() - same.float()).abs().max())
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        up = flash_prefill_ref(q.float(), k.float(), v.float(), causal=False)
        d = (out.float() - up).abs()
        assert bool((d <= up.abs() * 2.0 ** -8 + 1e-5).all()), float(d.max())


def _close(got, want):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, atol=LAYER_TOL * scale, rtol=LAYER_TOL)


def _on(tree, dev):
    return {k: _on(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


@pytest.mark.gpu
def test_cuda_mamba2_layer_prefill_matches_cpu():
    """One full-width mamba2-370m layer (fp32) over 300 tokens (two SSD
    chunks, the last padded): output, conv tails and h."""
    _require_sm90()
    cfg = dataclasses.replace(get_config("mamba2-370m"), num_layers=1, dtype=torch.float32)
    params = M2.init_params(cfg, 0, "cpu")
    lp = {k: v[0] for k, v in params["layers"].items()}
    u = torch.randn((1, 300, cfg.d_model), generator=torch.Generator().manual_seed(0))
    want = M2._layer(cfg, lp, u)
    got = M2._layer(cfg, _on(lp, "cuda"), u.cuda())
    _close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        _close(a, b)
    _close(got[2], want[2])


@pytest.mark.gpu
def test_cuda_griffin_layers_prefill_match_cpu():
    """One full-width recurrentgemma-2b rec block and one local-attention
    block (fp32) over 300 tokens: outputs, conv tail, h, K and V."""
    _require_sm90()
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=3,
                              dtype=torch.float32, vocab_size=16)
    gp = G._group(G.init_params(cfg, 0, "cpu"), 0)
    # at the init's scale the attention's scores are 256x too large (its
    # fan-in is read off the heads axis) and an fp32 summation-order
    # difference flips which key wins: temper wq and wk as chip_smoke does
    for name in ("wq", "wk"):
        gp["attn"][name] = gp["attn"][name] * (cfg.num_heads / cfg.d_model) ** 0.5
    x = torch.randn((1, 300, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(300)[None, :]
    want = G._rec_block(cfg, gp["rec0"], x)
    got = G._rec_block(cfg, _on(gp["rec0"], "cuda"), x.cuda())
    for a, b in zip(got, want):
        _close(a, b)
    want = G._attn_block_train(cfg, gp["attn"], x, pos)
    got = G._attn_block_train(cfg, _on(gp["attn"], "cuda"), x.cuda(), pos.cuda())
    _close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        _close(a, b)
