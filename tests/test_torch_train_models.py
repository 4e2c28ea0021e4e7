"""The port's training forward (``loss_fn`` / ``forward_train``) of every
family against the reference's, float32 on the CPU, on the reference's own
weights (bridged through ``from_reference``).

Bars: the loss within ``LOSS_TOL`` = 1e-5 (relative, and absolute at
|loss| <= 1) of ``repro``'s ``loss_fn``; every gradient leaf, torch autograd
against ``jax.grad``, within ``GRAD_TOL`` = 1e-4 of that leaf's max |g|
plus 1e-6. Every attention's ``wq`` / ``wk`` (and the cross-attention's)
is tempered by sqrt(H / d) in the reference's init before both packages
run, as chip_smoke's STATE_TEMPERED does: ``dense_init`` reads the heads
axis as their fan-in, and at that scale the smoke configs' random
attention is so peaked that float32 rounding alone moves the gradients by
more than the bar (the reference's own float32 gradients stood 1.3e-4
(recurrentgemma) and 2.8e-4 (seamless) of max |g| from its float64 ones;
tempered, both packages are within ~1e-5 of them). The families: dense
qwen3; moe granite under the dense,
``gshard`` and ``gshard_einsum`` dispatches (with the aux loss); vlm llava
with ``frontend_embeds`` and a ``loss_mask``; mamba2; recurrentgemma;
seamless. Each once as configured (plain attention, S <= flash_threshold)
and once with ``flash_threshold`` lowered below S and small chunks, so the
chunked flash branch (windowed for griffin) and the encoder's non-causal
chunked branch run; a few cases also under ``attn_wedge``. Then
``remat`` none / full / dots (``tests/test_perf_knobs.py:46-58``), the
wedge flash against direct attention (``tests/test_system.py:31-52``),
and K3 / K4 refusing autograd while training never launches them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.models.attention import attend as ref_attend  # noqa: E402
from repro.models.attention import causal_mask as ref_causal_mask  # noqa: E402
from repro.models.flash import flash_attention as ref_flash  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_prefill import ops as K4OPS  # noqa: E402
from repro_torch.kernels.paged_attention import ops as K3OPS  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import from_reference, to_numpy  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.flash import flash_attention  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# (arch, config overrides) by case name
CASES = {
    "qwen3": ("qwen3-1.7b", {}),
    "granite_dense": ("granite-moe-1b-a400m", {}),
    "granite_gshard": ("granite-moe-1b-a400m", {"moe_dispatch": "gshard"}),
    "granite_gshard_einsum": ("granite-moe-1b-a400m", {"moe_dispatch": "gshard_einsum"}),
    "llava": ("llava-next-34b", {}),
    "mamba2": ("mamba2-370m", {}),
    "recurrentgemma": ("recurrentgemma-2b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
}
# flash_threshold below S (and below the encoder's frames), chunks that do
# not divide S; mamba2's SSD in chunks of 5 (the last one padded)
FLASH = {"flash_threshold": 8, "attn_q_chunk": 6, "attn_kv_chunk": 5, "ssm_chunk": 5}


def _cfgs(arch, **over):
    return (dataclasses.replace(ref_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _batch(cfg, seed=0):
    """numpy batch: tokens / labels (B, S); llava's frontend embeddings and
    a loss mask; seamless's frames (B, 24, d) and a 12-token decoder."""
    rng = np.random.RandomState(seed)
    s = 12 if cfg.family == "encdec" else S
    toks = rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(B, 24, cfg.d_model).astype(np.float32)
    if cfg.frontend_tokens:
        batch["frontend_embeds"] = rng.randn(B, cfg.frontend_tokens,
                                             cfg.d_model).astype(np.float32)
        mask = np.ones((B, s), np.float32)
        mask[0, :5] = 0.0
        batch["loss_mask"] = mask
    return batch


def _tempered(tree, f):
    """``wq`` / ``wk`` / ``x_wq`` / ``x_wk`` scaled by ``f`` (a copy)."""
    if isinstance(tree, dict):
        return {k: v * f if k in ("wq", "wk", "x_wq", "x_wk") else _tempered(v, f)
                for k, v in tree.items()}
    return tree


def _ref_init(rcfg):
    params = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    if rcfg.num_heads:
        params = _tempered(params, (rcfg.num_heads / rcfg.d_model) ** 0.5)
    return params


def _ref_loss_and_grads(rcfg, batch):
    """The reference's (tempered) init, its loss and ``jax.grad`` (jitted:
    the eager trace of a smoke model takes seconds longer)."""
    model = ref_get_model(rcfg)
    rparams = _ref_init(rcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: model.loss(p, jb)))(rparams)
    return rparams, float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_loss_and_grads(cfg, rparams, batch):
    params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = get_model(cfg).loss(params, tb)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [to_numpy(g) for g in grads]


def _hold(got, want):
    loss, grads = got
    want_loss, want_grads = want
    assert abs(loss - want_loss) <= LOSS_TOL * max(1.0, abs(want_loss)), (loss, want_loss)
    assert len(grads) == len(want_grads)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(w).max()) + 1e-6,
                                   err_msg=f"grad leaf {i}")


# the flash branch is the attention's (and mamba2's chunking): the MoE
# dispatch variants take it as granite_dense does
MODES = [(case, "plain") for case in CASES] + [
    (case, "flash") for case in CASES if not case.startswith("granite_gshard")]


@pytest.mark.parametrize("case,mode", MODES)
def test_loss_and_grads_match_reference(case, mode):
    arch, over = CASES[case]
    over = dict(over, **(FLASH if mode == "flash" else {}))
    rcfg, cfg = _cfgs(arch, **over)
    batch = _batch(cfg)
    rparams, *want = _ref_loss_and_grads(rcfg, batch)
    _hold(_port_loss_and_grads(cfg, rparams, batch), want)


@pytest.mark.parametrize("case", ["qwen3", "llava", "seamless"])
def test_wedge_loss_and_grads_match_reference(case):
    """``attn_wedge`` above the lowered threshold: each query chunk contracts
    only its causal prefix (the encoder stays non-causal)."""
    arch, over = CASES[case]
    rcfg, cfg = _cfgs(arch, attn_wedge=True, **dict(over, **FLASH))
    batch = _batch(cfg, seed=1)
    rparams, *want = _ref_loss_and_grads(rcfg, batch)
    _hold(_port_loss_and_grads(cfg, rparams, batch), want)


def test_forward_train_shapes_and_aux():
    """forward_train returns fp32 logits over every position (the VLM's
    frontend ones included) and a scalar aux, non-zero only for MoE."""
    for case in ("llava", "granite_dense", "mamba2", "recurrentgemma"):
        arch, over = CASES[case]
        rcfg, cfg = _cfgs(arch, **over)
        batch = _batch(cfg)
        rparams = _ref_init(rcfg)
        params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
        from repro_torch.models import griffin, mamba2, transformer

        mod = {"ssm": mamba2, "hybrid": griffin}.get(cfg.family, transformer)
        fe = batch.get("frontend_embeds")
        args = () if fe is None else (torch.from_numpy(fe),)
        logits, aux = mod.forward_train(params, cfg, torch.from_numpy(batch["tokens"]), *args)
        assert logits.dtype == torch.float32
        assert logits.shape == (B, S + cfg.frontend_tokens, cfg.vocab_size)
        assert aux.shape == () and (float(aux) > 0) == (cfg.family == "moe")


# ---------------------------------------------------------------------------
# tests/test_perf_knobs.py:46-58 — remat preserves loss and grads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["granite_dense", "mamba2", "recurrentgemma", "seamless"])
def test_remat_preserves_loss_and_grads(case):
    """remat "full" (torch.utils.checkpoint per layer / griffin group) and
    "dots" (the weight GEMMs' outputs saved, the rest recomputed) give the
    loss and grads of "none", and the reference's."""
    arch, over = CASES[case]
    rcfg, cfg = _cfgs(arch, **dict(over, **FLASH))
    batch = _batch(cfg, seed=2)
    rparams, *want = _ref_loss_and_grads(rcfg, batch)
    base = _port_loss_and_grads(cfg, rparams, batch)
    _hold(base, want)
    for mode in ("full", "dots"):
        loss, grads = _port_loss_and_grads(dataclasses.replace(cfg, remat=mode), rparams, batch)
        np.testing.assert_allclose(loss, base[0], rtol=1e-6)
        for g, g0 in zip(grads, base[1]):
            np.testing.assert_allclose(g, g0, rtol=1e-5, atol=1e-7)


def test_remat_dots_saves_gemms_and_recomputes_the_rest():
    """Under "dots" the backward recomputes the layer but no weight GEMM
    (aten.mm); under "full" it recomputes both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    arch, _ = CASES["qwen3"]
    rcfg, cfg = _cfgs(arch)
    batch = _batch(cfg)
    rparams = _ref_init(rcfg)
    counts = {}
    for mode in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=mode)
        params = from_reference(jax.tree.map(np.asarray, rparams), c, device="cpu")
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        loss = get_model(c).loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
        with Count() as mode_ops:
            torch.autograd.grad(loss, leaves)
        counts[mode] = {op: mode_ops.ops.count(op)
                        for op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)}
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    # full recomputes each layer's weight GEMMs but the last (w_down: no
    # backward reads its output, and the non-reentrant recompute stops once
    # it has every saved tensor) and its 2 attention bmm's; dots the bmm's
    assert counts["full"][mm] == counts["none"][mm] + 6 * cfg.num_layers
    assert counts["dots"][mm] == counts["none"][mm]
    assert counts["full"][bmm] == counts["dots"][bmm] == counts["none"][bmm] + 2 * cfg.num_layers


# ---------------------------------------------------------------------------
# tests/test_system.py:31-52 — chunked / wedge / local flash against direct
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(q_chunk=32, kv_chunk=16),
    dict(q_chunk=32, wedge=True),
    dict(q_chunk=37, wedge=True),           # non-divisible wedge chunks
    dict(window=12, q_chunk=16),
    dict(q_chunk=37, kv_chunk=53),          # non-divisible chunking
])
def test_flash_matches_direct(kwargs):
    Bq, Sq, H, KV, HD = 2, 100, 4, 2, 16
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(Bq, Sq, n, HD).astype(np.float32) for n in (H, KV, KV))
    window = kwargs.get("window", 0)
    ref = ref_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     ref_causal_mask(Sq, Sq, 0, window)[None, None, None])
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, **kwargs)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), rtol=3e-5, atol=3e-5)
    ref_out = jax.jit(lambda a, b, c: ref_flash(a, b, c, causal=True, **kwargs))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref_out), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wedge", [False, True])
def test_flash_differentiable(wedge):
    """The chunked and wedge flash's gradients are finite and equal the
    reference's (jax.grad of the same sum)."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(1, 64, n, 8).astype(np.float32) for n in (2, 2, 2))
    kw = dict(q_chunk=16, kv_chunk=16, wedge=wedge)
    want = jax.jit(jax.grad(lambda qq: ref_flash(qq, jnp.asarray(k), jnp.asarray(v),
                                                 **kw).sum()))(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    (g,) = torch.autograd.grad(
        flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v), **kw).sum(), [qt])
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(to_numpy(g), np.asarray(want), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# K3 / K4 have no backward: they refuse autograd, and training avoids them
# ---------------------------------------------------------------------------
def test_kernels_refuse_autograd():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 8, 4, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 8, 2, 16).astype(np.float32))
    K4OPS.flash_prefill_op(q, k, k)                      # no grad: runs
    with pytest.raises(RuntimeError, match="no backward"):
        K4OPS.flash_prefill_op(q.requires_grad_(True), k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        K4OPS.flash_prefill_op(q.detach(), k.requires_grad_(True), k.detach(), causal=False)
    with torch.no_grad():                                # grad off: runs
        K4OPS.flash_prefill_op(q, k, k)
    pool = torch.zeros((4, 1, 2, 32 * 2 * 16))
    bt = torch.zeros((1, 1), dtype=torch.int32)
    ln = torch.ones((1,), dtype=torch.int32)
    q1 = torch.randn(1, 4, 16)
    K3OPS.paged_decode_attention(q1, pool, 0, bt, ln, block_size=32)
    with pytest.raises(RuntimeError, match="no backward"):
        K3OPS.paged_decode_attention(q1.requires_grad_(True), pool, 0, bt, ln, block_size=32)
    with pytest.raises(RuntimeError, match="no backward"):
        K3OPS.paged_decode_attention(q1.detach(), pool.requires_grad_(True), 0, bt, ln,
                                     block_size=32)


@pytest.mark.parametrize("case", ["qwen3", "recurrentgemma", "seamless"])
def test_training_never_reaches_the_kernels(case, monkeypatch):
    """Above the lowered threshold, serving's prefill calls K4's op and the
    loss's forward and backward never do (nor K3's)."""
    calls = []

    def spy(name, orig):
        def f(*a, **kw):
            calls.append(name)
            return orig(*a, **kw)
        return f

    monkeypatch.setattr(K4OPS, "flash_prefill_op", spy("k4", K4OPS.flash_prefill_op))
    import repro_torch.kernels.flash_prefill as K4PKG
    import repro_torch.kernels.paged_attention as K3PKG

    monkeypatch.setattr(K4PKG, "flash_prefill_op", K4OPS.flash_prefill_op)
    monkeypatch.setattr(K3PKG, "paged_decode_attention",
                        spy("k3", K3PKG.paged_decode_attention))
    arch, over = CASES[case]
    rcfg, cfg = _cfgs(arch, **dict(over, **FLASH))
    batch = _batch(cfg)
    rparams = _ref_init(rcfg)
    params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = get_model(cfg)
    torch.autograd.grad(model.loss(params, tb), leaves)
    assert calls == []
    if cfg.family != "hybrid":          # griffin's windowed attention never takes K4
        with torch.no_grad():
            model.prefill(params, tb)
        assert "k4" in calls


def test_attention_train_flag_routes_the_flash_branch(monkeypatch):
    """self_attention(train=True) above the threshold equals the chunked
    flash on the same q, k, v; serving (train=False) takes K4's op."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), **FLASH)
    rng = np.random.RandomState(3)
    lp = {n: torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.2)
          for n, shape in A.attn_param_shapes(cfg).items()}
    x = torch.from_numpy(rng.randn(B, S, cfg.d_model).astype(np.float32))
    pos = torch.arange(S)[None, :]
    served, _ = A.self_attention(lp, x, cfg, pos)
    trained, _ = A.self_attention(lp, x, cfg, pos, train=True)
    np.testing.assert_allclose(to_numpy(trained), to_numpy(served), rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(K4OPS, "flash_prefill_op", None)   # train never looks it up
    import repro_torch.kernels.flash_prefill as K4PKG
    monkeypatch.setattr(K4PKG, "flash_prefill_op", None)
    A.self_attention(lp, x, cfg, pos, train=True)
    with pytest.raises(TypeError):
        A.self_attention(lp, x, cfg, pos)
