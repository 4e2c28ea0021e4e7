"""The port's dense transformer against the reference on the reference's own
weights (bridged through ``from_reference``), smoke configs qwen3-1.7b
(GQA, qk-norm) and gemma-2b (MQA, GeGLU, embedding scale), float32.

Bars: logits and K/V within rtol = 1e-5 and atol = 1e-5 * max(1, max|ref|)
(for scale, the reference's own suffix-vs-cold gap on CPU is 1.3e-7 in
logits and 7.6e-6 in V). The absolute error of an fp32 contraction grows
with its operands, so an entry that cancels to near zero carries its
neighbours' error: gemma's sqrt(d) embedding scale puts K at |x| ~ 17 and a
near-zero K entry off by 3e-5. Greedy tokens identical, bf16 bridging
bit-exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.block_manager import BlockManager  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.bridge import from_reference, to_numpy  # noqa: E402

TOL = 1e-5
ARCHS = ["qwen3-1.7b", "gemma-2b"]


def _configs(arch, **over):
    return (dataclasses.replace(ref_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    rcfg, cfg = _configs(request.param)
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, rparams)
    return rcfg, rparams, cfg, from_reference(params_np, cfg, device="cpu")


def _tokens(cfg, n, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(1, n)).astype(np.int32)


def _close(got, want, **tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(to_numpy(got), want,
                               **(tol or dict(atol=TOL * scale, rtol=TOL)))


def test_prefill_matches_reference(models):
    rcfg, rparams, cfg, params = models
    toks = _tokens(cfg, 21)
    rl, rc = RT.prefill(rparams, rcfg, jnp.asarray(toks))
    l, c = T.prefill(params, cfg, torch.from_numpy(toks))
    _close(l, rl)
    _close(c["k"], rc["k"])
    _close(c["v"], rc["v"])
    assert c["length"].tolist() == np.asarray(rc["length"]).tolist()


def test_prefill_flash_path_matches_reference(models):
    """Above flash_threshold both packages take the chunked flash path."""
    rcfg, rparams, cfg, params = models
    over = dict(flash_threshold=16, attn_q_chunk=8, attn_kv_chunk=16)
    rcfg, cfg = dataclasses.replace(rcfg, **over), dataclasses.replace(cfg, **over)
    toks = _tokens(cfg, 40, seed=1)
    rl, rc = RT.prefill(rparams, rcfg, jnp.asarray(toks))
    l, c = T.prefill(params, cfg, torch.from_numpy(toks))
    _close(l, rl)
    _close(c["k"], rc["k"])
    _close(c["v"], rc["v"])


@pytest.mark.parametrize("window", [0, 6])
def test_flash_attention_matches_reference(window):
    from repro.models.flash import flash_attention as ref_flash
    from repro_torch.models.flash import flash_attention
    rng = np.random.RandomState(4)
    q = rng.randn(2, 20, 4, 8).astype(np.float32)
    k = rng.randn(2, 36, 2, 8).astype(np.float32)
    v = rng.randn(2, 36, 2, 8).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=8, kv_chunk=16, q_offset=16)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    _close(got, want)


def test_prefill_suffix_matches_reference(models):
    rcfg, rparams, cfg, params = models
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
    assert c["length"].tolist() == [45]


def test_decode_step_matches_reference(models):
    rcfg, rparams, cfg, params = models
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
    _close(c["v"], rc["v"])
    assert c["length"].tolist() == [18]


def test_greedy_generate_token_identical(models):
    rcfg, rparams, cfg, params = models
    toks = _tokens(cfg, 23, seed=5)
    want = RT.greedy_generate(rparams, rcfg, jnp.asarray(toks), 6)
    got = T.greedy_generate(params, cfg, torch.from_numpy(toks), 6)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("batch", [1, 3])
def test_decode_step_paged_matches_reference(models, batch):
    """Port (plain kernel versions) vs reference (Pallas interpret), pool
    from a block manager, ragged lengths, pow2 pad lanes copying lane 0."""
    rcfg, rparams, cfg, params = models
    L, bs, KV, hd = cfg.num_layers, cfg.block_size, cfg.num_kv_heads, cfg.head_dim
    nb = 16
    lengths = [37, 5, 70][:batch]
    bm = BlockManager(nb, bs, "flowkv")
    for rid, n in enumerate(lengths):
        bm.allocate(rid, n + 1)
    bp = 1 << max(0, batch - 1).bit_length()
    w = 1 << max(0, max(len(bm.get(r)) for r in range(batch)) - 1).bit_length()
    bt = np.zeros((bp, w), np.int32)
    for rid in range(batch):
        bt[rid, :len(bm.get(rid))] = bm.get(rid)
    bt[batch:] = bt[0]
    lens = np.array(lengths + [lengths[0]] * (bp - batch), np.int32)
    toks = np.random.RandomState(batch).randint(0, cfg.vocab_size, size=bp).astype(np.int32)
    toks[batch:] = toks[0]
    pool = np.random.RandomState(7).randn(nb, L, 2, bs * KV * hd).astype(np.float32)
    rl, rpool = RT.decode_step_paged(rparams, rcfg, jnp.asarray(toks), jnp.asarray(pool),
                                     jnp.asarray(bt), jnp.asarray(lens))
    l, ppool = T.decode_step_paged(params, cfg, torch.from_numpy(toks),
                                   torch.from_numpy(pool.copy()), torch.from_numpy(bt),
                                   torch.from_numpy(lens))
    _close(l, rl)
    _close(ppool, rpool)
    assert l.argmax(-1).tolist() == np.asarray(rl).argmax(-1).tolist()


def test_attention_scales_match_reference_bf16():
    """The dense path divides by sqrt(hd) rounded to q.dtype, the in-flight
    merge by an fp32 sqrt(hd); both match the reference in bf16."""
    rng = np.random.RandomState(8)
    q = rng.randn(1, 5, 4, 128)
    k = rng.randn(1, 7, 2, 128)
    v = rng.randn(1, 7, 2, 128)
    mask = RA.causal_mask(5, 7, 2)[None, None, None]
    want = RA.attend(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), mask)
    got = A.attend(torch.tensor(q, dtype=torch.bfloat16), torch.tensor(k, dtype=torch.bfloat16),
                   torch.tensor(v, dtype=torch.bfloat16),
                   A.causal_mask(5, 7, 2)[None, None, None])
    _close(got, want, atol=2e-2, rtol=2e-2)
    q1, k1, v1 = rng.randn(2, 4, 16), rng.randn(2, 2, 16), rng.randn(2, 2, 16)
    o, m, l = rng.randn(2, 4, 16), rng.randn(2, 2, 2), rng.rand(2, 2, 2) + 0.5
    args = [a.astype(np.float32) for a in (q1, k1, v1, o, m, l)]
    want = RA.merge_inflight_token(*map(jnp.asarray, args), jnp.float32)
    got = A.merge_inflight_token(*map(torch.from_numpy, args), torch.float32)
    _close(got, want)


def test_bf16_bridge_roundtrip_bit_exact():
    rcfg, cfg = _configs("qwen3-1.7b")
    rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(1))
    params_np = jax.tree.map(np.asarray, rparams)
    params = from_reference(params_np, cfg, device="cpu")
    ref_leaves = jax.tree.leaves(params_np)
    port_leaves = jax.tree.leaves(params)
    assert len(ref_leaves) == len(port_leaves)
    for a, t in zip(ref_leaves, port_leaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
