"""The port's MoE FFN and the MoE / VLM transformer against the reference on
the reference's own weights (bridged through ``from_reference``), float32,
on the CPU.

Bars: each of the four MoE dispatches (dense, gshard, gshard_einsum,
top-1 sparse) gives the reference's output and aux loss within 1e-5
(rtol, and atol scaled by max(1, max|ref|)); the one-hot einsum dispatch
equals the dense dispatch at capacity 8.0 (no token dropped), as the
reference's ``test_perf_knobs.py`` checks; granite-moe and llama4-scout
smoke prefill, suffix prefill, dense-cache and paged decode steps match the
reference within 1e-5 with identical greedy tokens; decode equals the
prefill of the longer sequence (the reference's moe_top2 / moe_top1 cases
of ``test_models.py``, against prefill since the port has no training
forward); the VLM splice and llava-next's smoke prefill with
``frontend_embeds`` match the reference, token for token; the bridge
carries the ``moe_*`` leaves bit for bit in float32 and bfloat16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.models.common import ModelConfig as RefConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.block_manager import BlockManager  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import from_reference, to_numpy  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402

TOL = 1e-5
MOE_ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(to_numpy(got), want, atol=tol * scale, rtol=tol)


def _bridge(rparams, cfg):
    return from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")


# ---------------------------------------------------------------------------
# The four dispatches, function by function
# ---------------------------------------------------------------------------
def _moe_cfgs(**kw):
    base = dict(name="moe", family="moe", num_layers=1, d_model=16, vocab_size=32,
                num_heads=2, num_kv_heads=2, head_dim=8, num_experts=4, top_k=2,
                moe_d_ff=32)
    base.update(kw)
    return RefConfig(dtype=jnp.float32, **base), ModelConfig(dtype=torch.float32, **base)


def _moe_inputs(rcfg, seed=0, shape=(2, 12, 16)):
    shapes = RMOE.moe_param_shapes(rcfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shapes) + 1)
    rp = {n: jax.random.normal(k, s, jnp.float32) * s[-2] ** -0.5
          for (n, s), k in zip(shapes.items(), keys)}
    x = jax.random.normal(keys[-1], shape, jnp.float32)
    p = {n: torch.from_numpy(np.array(v)) for n, v in rp.items()}
    return rp, x, p, torch.from_numpy(np.array(x))


DISPATCHES = {
    "dense": (lambda p, x, c: RMOE.moe_ffn(p, x, c), lambda p, x, c: MOE.moe_ffn(p, x, c), {}),
    "gshard": (lambda p, x, c: RMOE.moe_ffn_gshard(p, x, c, 1.25),
               lambda p, x, c: MOE.moe_ffn_gshard(p, x, c, 1.25), {}),
    "gshard_einsum": (lambda p, x, c: RMOE.moe_ffn_gshard_einsum(p, x, c, 1.25),
                      lambda p, x, c: MOE.moe_ffn_gshard_einsum(p, x, c, 1.25), {}),
    "topk_sparse": (lambda p, x, c: RMOE.moe_ffn_topk_sparse(p, x, c),
                    lambda p, x, c: MOE.moe_ffn_topk_sparse(p, x, c), {"top_k": 1}),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(DISPATCHES))
def test_dispatch_matches_reference(name, seed):
    """Output and aux loss of each dispatch within 1e-5 of the reference's;
    at capacity 1.25 the gshard dispatches drop tokens, so their overflow
    rule is held too."""
    ref_fn, port_fn, over = DISPATCHES[name]
    rcfg, cfg = _moe_cfgs(**over)
    rp, x, p, xt = _moe_inputs(rcfg, seed)
    want, want_aux = ref_fn(rp, x, rcfg)
    got, aux = port_fn(p, xt, cfg)
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)


def test_gshard_dispatch_drops_tokens_at_low_capacity():
    """At capacity 0.5 some (token, expert) choices overflow: both gshard
    forms still equal the reference's, and differ from dense dispatch."""
    rcfg, cfg = _moe_cfgs()
    rp, x, p, xt = _moe_inputs(rcfg, 3)
    dense, _ = MOE.moe_ffn(p, xt, cfg)
    for ref_fn, fn in ((RMOE.moe_ffn_gshard, MOE.moe_ffn_gshard),
                       (RMOE.moe_ffn_gshard_einsum, MOE.moe_ffn_gshard_einsum)):
        want, want_aux = ref_fn(rp, x, rcfg, 0.5)
        got, aux = fn(p, xt, cfg, 0.5)
        _close(got, want)
        _close(aux, want_aux)
        assert float((got - dense).abs().max()) > 1e-3


def test_gshard_einsum_matches_dense_dispatch():
    """Capacity 8.0 drops nothing, so the one-hot einsum dispatch is the
    dense dispatch (the reference's test_perf_knobs bar, 1e-4)."""
    rcfg, cfg = _moe_cfgs()
    _, _, p, xt = _moe_inputs(rcfg, 1)
    want, _ = MOE.moe_ffn(p, xt, cfg)
    got, _ = MOE.moe_ffn_gshard_einsum(p, xt, cfg, capacity_factor=8.0)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The MoE transformer (granite-moe top-8 style, llama4-scout top-1)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_models(request):
    rcfg, cfg = ref_smoke(request.param), get_smoke_config(request.param)
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, rparams, cfg, _bridge(rparams, cfg)


def _tokens(cfg, n, seed=0, b=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(b, n)).astype(np.int32)


def test_moe_param_tree_and_axes_match_reference(moe_models):
    rcfg, rparams, cfg, params = moe_models
    assert sorted(params["layers"]) == sorted(rparams["layers"])
    assert any(k.startswith("moe_") for k in params["layers"])
    assert "w_gate" not in params["layers"]
    own = T.init_params(cfg, 0, device="cpu")
    for name, leaf in params["layers"].items():
        assert tuple(own["layers"][name].shape) == tuple(leaf.shape), name
    assert T.param_axes(cfg) == jax.tree.map(
        lambda a: a, RT.param_axes(rcfg), is_leaf=lambda a: isinstance(a, tuple))


def test_moe_prefill_matches_reference(moe_models):
    rcfg, rparams, cfg, params = moe_models
    toks = _tokens(cfg, 21)
    rl, rc = RT.prefill(rparams, rcfg, jnp.asarray(toks))
    l, c = T.prefill(params, cfg, torch.from_numpy(toks))
    _close(l, rl)
    _close(c["k"], rc["k"])
    _close(c["v"], rc["v"])


def test_moe_prefill_suffix_matches_reference(moe_models):
    rcfg, rparams, cfg, params = moe_models
    toks = _tokens(cfg, 45, seed=2)
    _, pre = RT.prefill(rparams, rcfg, jnp.asarray(toks[:, :32]))
    pk, pv = np.array(pre["k"]), np.array(pre["v"])
    rl, rc = RT.prefill_suffix(rparams, rcfg, jnp.asarray(toks[:, 32:]),
                               jnp.asarray(pk), jnp.asarray(pv))
    l, c = T.prefill_suffix(params, cfg, torch.from_numpy(toks[:, 32:]),
                            torch.from_numpy(pk), torch.from_numpy(pv))
    _close(l, rl)
    _close(c["k"], rc["k"])
    _close(c["v"], rc["v"])


def test_moe_decode_step_matches_reference(moe_models):
    rcfg, rparams, cfg, params = moe_models
    toks = _tokens(cfg, 17, seed=3)
    _, pre = RT.prefill(rparams, rcfg, jnp.asarray(toks))
    cache = RT.init_cache(rcfg, 1, 24)
    cache["k"] = cache["k"].at[:, :, :17].set(pre["k"])
    cache["v"] = cache["v"].at[:, :, :17].set(pre["v"])
    cache["length"] = jnp.full((1,), 17, jnp.int32)
    tok = np.array([5], np.int32)
    rl, rc = RT.decode_step(rparams, rcfg, jnp.asarray(tok), cache)
    pcache = {"k": torch.from_numpy(np.array(cache["k"])),
              "v": torch.from_numpy(np.array(cache["v"])),
              "length": torch.tensor([17], dtype=torch.int32)}
    l, c = T.decode_step(params, cfg, torch.from_numpy(tok), pcache)
    _close(l, rl)
    _close(c["k"], rc["k"])


def test_moe_decode_paged_matches_reference(moe_models):
    """B=3 ragged lengths with one pad lane copying lane 0, the pool from a
    block manager: logits and the appended pool within 1e-5."""
    rcfg, rparams, cfg, params = moe_models
    L, bs, KV, hd = cfg.num_layers, cfg.block_size, cfg.num_kv_heads, cfg.head_dim
    nb, lengths = 16, [37, 5, 70]
    bm = BlockManager(nb, bs, "flowkv")
    for rid, n in enumerate(lengths):
        bm.allocate(rid, n + 1)
    bt = np.zeros((4, 4), np.int32)
    for rid in range(3):
        bt[rid, :len(bm.get(rid))] = bm.get(rid)
    bt[3:] = bt[0]
    lens = np.array(lengths + lengths[:1], np.int32)
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, size=4).astype(np.int32)
    toks[3] = toks[0]
    pool = np.random.RandomState(7).randn(nb, L, 2, bs * KV * hd).astype(np.float32)
    rl, rpool = RT.decode_step_paged(rparams, rcfg, jnp.asarray(toks), jnp.asarray(pool),
                                     jnp.asarray(bt), jnp.asarray(lens))
    l, ppool = get_model(cfg).decode_paged(params, torch.from_numpy(toks),
                                           torch.from_numpy(pool.copy()),
                                           torch.from_numpy(bt), torch.from_numpy(lens))
    _close(l, rl)
    _close(ppool, rpool)
    assert l.argmax(-1).tolist() == np.asarray(rl).argmax(-1).tolist()


def test_moe_greedy_generate_token_identical(moe_models):
    rcfg, rparams, cfg, params = moe_models
    toks = _tokens(cfg, 23, seed=5, b=2)
    want = RT.greedy_generate(rparams, rcfg, jnp.asarray(toks), 6)
    got = T.greedy_generate(params, cfg, torch.from_numpy(toks), 6)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("top_k,sparse", [(2, False), (1, False), (1, True)],
                         ids=["moe_top2", "moe_top1", "moe_top1_sparse"])
def test_moe_decode_matches_prefill(top_k, sparse):
    """The reference's decode-against-train cases (test_models.py): three
    decode steps on the dense cache give the logits of the prefill of the
    longer sequence (the port has no training forward), and the reference's
    decode logits, on the same bridged weights."""
    over = dict(name="t", family="moe", num_layers=2, d_model=32, vocab_size=64,
                num_heads=4, num_kv_heads=2, head_dim=8, d_ff=0, moe_d_ff=32,
                num_experts=4, top_k=top_k, moe_sparse_dispatch=sparse)
    rcfg, cfg = RefConfig(dtype=jnp.float32, **over), ModelConfig(dtype=torch.float32, **over)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    params = _bridge(rparams, cfg)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 9), 0, 64), np.int32)
    full = np.concatenate([toks, toks[:, :3]], axis=1)
    lg, pre = T.prefill(params, cfg, torch.from_numpy(toks))
    cache = T.init_cache(cfg, 2, 12, device="cpu")
    cache["k"][:, :, :9], cache["v"][:, :, :9] = pre["k"], pre["v"]
    cache["length"] = torch.full((2,), 9, dtype=torch.int32)
    rcache = RT.init_cache(rcfg, 2, 12)
    _, rpre = RT.prefill(rparams, rcfg, jnp.asarray(toks))
    rcache["k"] = rcache["k"].at[:, :, :9].set(rpre["k"])
    rcache["v"] = rcache["v"].at[:, :, :9].set(rpre["v"])
    rcache["length"] = jnp.full((2,), 9, jnp.int32)
    for i in range(3):
        tok = full[:, 9 + i]
        lg, cache = T.decode_step(params, cfg, torch.from_numpy(tok), cache)
        rlg, rcache = RT.decode_step(rparams, rcfg, jnp.asarray(tok), rcache)
        want, _ = T.prefill(params, cfg, torch.from_numpy(full[:, :10 + i]))
        np.testing.assert_allclose(to_numpy(lg), to_numpy(want), rtol=2e-3, atol=2e-3)
        _close(lg, rlg)


# ---------------------------------------------------------------------------
# The VLM splice
# ---------------------------------------------------------------------------
def test_vlm_frontend_splice():
    """frontend_embeds (B, F, D) spliced in front of the text: the prefill
    covers F + S positions, and its logits and K/V equal the reference's."""
    over = dict(name="t", family="vlm", num_layers=2, d_model=32, vocab_size=64,
                num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, frontend="vision",
                frontend_tokens=4)
    rcfg, cfg = RefConfig(dtype=jnp.float32, **over), ModelConfig(dtype=torch.float32, **over)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    params = _bridge(rparams, cfg)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 6), 0, 64), np.int32)
    fe = np.array(jax.random.normal(jax.random.PRNGKey(2), (2, 4, 32)), np.float32)
    rl, rc = RT.prefill(rparams, rcfg, jnp.asarray(toks), jnp.asarray(fe))
    l, c = get_model(cfg).prefill(params, {"tokens": torch.from_numpy(toks),
                                           "frontend_embeds": torch.from_numpy(fe)})
    assert tuple(c["k"].shape)[2] == 10 and c["length"].tolist() == [10, 10]
    _close(l, rl)
    _close(c["k"], rc["k"])
    _close(c["v"], rc["v"])
    plain, _ = T.prefill(params, cfg, torch.from_numpy(toks))
    assert float((plain - l).abs().max()) > 1e-3          # the frontend matters


def test_llava_next_smoke_frontend_token_identical():
    """llava-next's smoke config with its 16 patch embeddings: the prefill's
    first token and five dense-cache decode steps are the reference's."""
    rcfg, cfg = ref_smoke("llava-next-34b"), get_smoke_config("llava-next-34b")
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    params = _bridge(rparams, cfg)
    toks = _tokens(cfg, 20, seed=9)
    fe = np.random.RandomState(10).randn(1, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
    rl, rpre = ref_get_model(rcfg).prefill(rparams, {"tokens": jnp.asarray(toks),
                                                     "frontend_embeds": jnp.asarray(fe)})
    l, pre = get_model(cfg).prefill(params, {"tokens": torch.from_numpy(toks),
                                             "frontend_embeds": torch.from_numpy(fe)})
    _close(l, rl)
    n = pre["k"].shape[2]
    rcache, cache = RT.init_cache(rcfg, 1, n + 6), T.init_cache(cfg, 1, n + 6, device="cpu")
    rcache["k"] = rcache["k"].at[:, :, :n].set(rpre["k"])
    rcache["v"] = rcache["v"].at[:, :, :n].set(rpre["v"])
    rcache["length"] = jnp.full((1,), n, jnp.int32)
    cache["k"][:, :, :n], cache["v"][:, :, :n] = pre["k"], pre["v"]
    cache["length"] = torch.full((1,), n, dtype=torch.int32)
    want, got = [int(jnp.argmax(rl[0]))], [int(torch.argmax(l[0]))]
    for _ in range(5):
        rl, rcache = RT.decode_step(rparams, rcfg, jnp.asarray([want[-1]], jnp.int32), rcache)
        l, cache = T.decode_step(params, cfg, torch.tensor([got[-1]], dtype=torch.int32), cache)
        want.append(int(jnp.argmax(rl[0])))
        got.append(int(torch.argmax(l[0])))
    assert got == want


# ---------------------------------------------------------------------------
# The weight bridge carries the moe_* leaves bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_moe_leaves_bit_exact(dtype):
    rcfg = dataclasses.replace(ref_smoke("granite-moe-1b-a400m"), dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              dtype=getattr(torch, dtype))
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(2))
    params_np = jax.tree.map(np.asarray, rparams)
    params = from_reference(params_np, cfg, device="cpu")
    moe = [k for k in params_np["layers"] if k.startswith("moe_")]
    assert sorted(moe) == ["moe_router", "moe_w_down", "moe_w_gate", "moe_w_up"]
    for name in moe:
        a, t = params_np["layers"][name], params["layers"][name]
        assert t.dtype == cfg.dtype and tuple(t.shape) == a.shape
        iview = np.int16 if dtype == "bfloat16" else np.int32
        tview = torch.int16 if dtype == "bfloat16" else torch.int32
        np.testing.assert_array_equal(t.view(tview).numpy(), a.view(iview))
