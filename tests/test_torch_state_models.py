"""The port's state families (mamba2, griffin, encdec) against the reference
on the reference's own weights (bridged through ``from_reference``),
float32, on the CPU.

Bars: the cases of ``tests/test_models.py:56-119``, decode (and prefill)
against the reference's training forward, computed in JAX, within the
reference's own 2e-3 / 5e-3; the chunk-size invariance of the SSD (chunk 4
against 11) within its 1e-4; the ``test_arch_smoke.py`` prefill/decode case
of the three archs; for each family, prefill logits, every cache leaf and
four decode steps within ``TOL`` = 1e-4 of the reference (atol scaled by
max(1, max|ref|): the fp32 summation orders differ, the RG-LRU's scan most)
with identical greedy tokens; griffin past ``window + q_chunk`` (the ring
wraps and the local flash takes its span branch); enc-dec's encoder above a
lowered ``flash_threshold`` through K4's plain version, non-causal; the
Hillis-Steele scan and the chunked SSD against their plain recurrences; the
bridge bit for bit; the port's init in the reference's layout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import griffin as RG  # noqa: E402
from repro.models import mamba2 as RM2  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.models.common import ModelConfig as RefConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_prefill import ops as K4OPS  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import griffin as G  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import from_reference, to_numpy  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402

TOL = 1e-4
ARCHS = ["mamba2-370m", "recurrentgemma-2b", "seamless-m4t-large-v2"]


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


def _cfgs(**kw):
    """The same config in both packages (float32)."""
    return RefConfig(dtype=jnp.float32, **kw), ModelConfig(dtype=torch.float32, **kw)


def _bridge(rparams, cfg):
    return from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# tests/test_models.py:56-119, decode against the reference's train forward
# ---------------------------------------------------------------------------
MAMBA_KW = dict(name="m", family="ssm", num_layers=2, d_model=32, vocab_size=64,
                ssm_state=8, ssm_expand=2, ssm_head_dim=8, ssm_conv=4, ssm_chunk=4)


def test_mamba2_decode_matches_train():
    rcfg, cfg = _cfgs(**MAMBA_KW)
    rp = RM2.init_params(rcfg, jax.random.PRNGKey(0))
    p = _bridge(rp, cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 11), 0, 64)
    logits, _ = RM2.forward_train(rp, rcfg, toks)
    c = M2.init_cache(cfg, 2, device="cpu")
    for i in range(11):
        lg, c = M2.decode_step(p, cfg, _t(toks[:, i]), c)
        np.testing.assert_allclose(to_numpy(lg), np.asarray(logits[:, i]),
                                   rtol=5e-3, atol=5e-3)
    assert int(c["length"][0]) == 11
    # chunk-size invariance: the port's prefill at chunk 4 (three chunks, the
    # last one padded) and at chunk 11 (one chunk), against the train
    # forward's last logits, against each other and against the decode loop
    lg4, c4 = M2.prefill(p, cfg, _t(toks))
    lg11, c11 = M2.prefill(p, dataclasses.replace(cfg, ssm_chunk=11), _t(toks))
    for lg in (lg4, lg11):
        np.testing.assert_allclose(to_numpy(lg), np.asarray(logits[:, -1]),
                                   rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(to_numpy(lg11), to_numpy(lg4), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_numpy(c11["h"]), to_numpy(c4["h"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_numpy(c["h"]), to_numpy(c4["h"]), rtol=1e-4, atol=1e-4)


GRIFFIN_KW = dict(name="g", family="hybrid", num_layers=8, d_model=16, vocab_size=50,
                  num_heads=2, num_kv_heads=1, head_dim=8, d_ff=32, attn_window=4,
                  layer_pattern=("rec", "rec", "attn"), lru_width=16)


def test_griffin_decode_matches_train():
    rcfg, cfg = _cfgs(**GRIFFIN_KW)
    rp = RG.init_params(rcfg, jax.random.PRNGKey(0))
    p = _bridge(rp, cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 11), 0, 50)
    logits, _ = RG.forward_train(rp, rcfg, toks)
    lg, cache = G.prefill(p, cfg, _t(toks))
    np.testing.assert_allclose(to_numpy(lg), np.asarray(logits[:, -1]), rtol=2e-3, atol=2e-3)
    full = jnp.concatenate([toks, toks[:, :3]], axis=1)
    logits_full, _ = RG.forward_train(rp, rcfg, full)
    for i in range(3):
        lg, cache = G.decode_step(p, cfg, _t(full[:, 11 + i]), cache)
        np.testing.assert_allclose(to_numpy(lg), np.asarray(logits_full[:, 11 + i]),
                                   rtol=5e-3, atol=5e-3)


ENCDEC_KW = dict(name="e", family="encdec", num_layers=2, num_encoder_layers=2,
                 d_model=16, vocab_size=50, num_heads=2, num_kv_heads=2, head_dim=8,
                 d_ff=32, cross_attention=True, frontend="audio")


def _padded(cfg, cache, batch, max_len, enc_len):
    """The prefill's cache copied into ``init_cache(max_len)`` (decode
    writes at ``length``, past the prefill's own cache)."""
    s = cache["k"].shape[2]
    c = E.init_cache(cfg, batch, max_len, enc_len, device=cache["k"].device)
    c["k"][:, :, :s] = cache["k"]
    c["v"][:, :, :s] = cache["v"]
    c["cross_k"], c["cross_v"] = cache["cross_k"], cache["cross_v"]
    c["length"] = cache["length"].clone()
    return c


def test_encdec_decode_matches_train():
    rcfg, cfg = _cfgs(**ENCDEC_KW)
    rp = RE.init_params(rcfg, jax.random.PRNGKey(0))
    p = _bridge(rp, cfg)
    frames = jax.random.normal(jax.random.PRNGKey(1), (2, 7, 16))
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 6), 0, 50)
    logits, _ = RE.forward_train(rp, rcfg, {"frames": frames, "tokens": toks})
    lg, cache = E.prefill(p, cfg, {"frames": _t(frames), "tokens": _t(toks)})
    np.testing.assert_allclose(to_numpy(lg), np.asarray(logits[:, -1]), rtol=2e-3, atol=2e-3)
    c = _padded(cfg, cache, 2, 10, 7)
    full = jnp.concatenate([toks, toks[:, :2]], axis=1)
    logits_full, _ = RE.forward_train(rp, rcfg, {"frames": frames, "tokens": full})
    for i in range(2):
        lg, c = E.decode_step(p, cfg, _t(full[:, 6 + i]), c)
        np.testing.assert_allclose(to_numpy(lg), np.asarray(logits_full[:, 6 + i]),
                                   rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# test_arch_smoke.py's prefill/decode case, and parity per family
# ---------------------------------------------------------------------------
_SMOKE = {}


def _smoke(arch):
    if arch not in _SMOKE:
        rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
        rp = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
        _SMOKE[arch] = (rcfg, rp, cfg, _bridge(rp, cfg))
    return _SMOKE[arch]


def _batches(cfg, tokens, frames=None):
    rb = {"tokens": jnp.asarray(tokens)}
    b = {"tokens": torch.from_numpy(np.asarray(tokens, np.int32))}
    if frames is not None:
        rb["frames"] = jnp.asarray(frames)
        b["frames"] = torch.from_numpy(np.asarray(frames, np.float32))
    return rb, b


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_prefill_decode(arch):
    """The reference's smoke case, run by both packages on the same params:
    shapes, finiteness and ``length`` as there, values within TOL."""
    rcfg, rp, cfg, p = _smoke(arch)
    B, S = 2, 8
    rmodel, model = ref_get_model(rcfg), get_model(cfg)
    if cfg.family == "encdec":
        rb, b = _batches(cfg, np.ones((B, 4), np.int32), np.ones((B, S, cfg.d_model)))
    else:
        rb, b = _batches(cfg, np.ones((B, S), np.int32))
    rlogits, rcache = rmodel.prefill(rp, rb)
    logits, cache = model.prefill(p, b)
    assert logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    _close(logits, rlogits)
    if cfg.family == "encdec":
        rc = rmodel.init_cache(B, 16, enc_len=S)
        rc["k"] = rc["k"].at[:, :, :4].set(rcache["k"])
        rc["v"] = rc["v"].at[:, :, :4].set(rcache["v"])
        rc["cross_k"], rc["cross_v"] = rcache["cross_k"], rcache["cross_v"]
        rc["length"] = jnp.full((B,), 4, jnp.int32)
        rcache, cache = rc, _padded(cfg, cache, B, 16, S)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    rlogits2, rcache2 = rmodel.decode(rp, jnp.asarray(to_numpy(tok), jnp.int32), rcache)
    length = int(cache["length"][0])
    logits2, cache2 = model.decode(p, tok, cache)
    assert logits2.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits2).all())
    assert int(cache2["length"][0]) == length + 1 == int(rcache2["length"][0])
    _close(logits2, rlogits2)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_prefill_cache_and_decode_match_reference(arch):
    """Prefill logits and every cache leaf, then four greedy decode steps:
    within TOL of the reference, the same tokens."""
    rcfg, rp, cfg, p = _smoke(arch)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 30)).astype(np.int32)
    frames = rng.randn(2, 12, cfg.d_model).astype(np.float32) \
        if cfg.family == "encdec" else None
    rb, b = _batches(cfg, toks, frames)
    rmodel, model = ref_get_model(rcfg), get_model(cfg)
    rl, rcache = rmodel.prefill(rp, rb)
    lg, cache = model.prefill(p, b)
    _close(lg, rl)
    assert sorted(cache) == sorted(rcache)
    for k in rcache:
        assert cache[k].dtype == {"float32": torch.float32, "int32": torch.int32}[
            str(rcache[k].dtype)], k
        _close(cache[k], rcache[k])
    if cfg.family == "encdec":
        rc = rmodel.init_cache(2, 40, enc_len=12)
        for k in ("k", "v"):
            rc[k] = rc[k].at[:, :, :30].set(rcache[k])
        rc.update(cross_k=rcache["cross_k"], cross_v=rcache["cross_v"],
                  length=rcache["length"])
        rcache, cache = rc, _padded(cfg, cache, 2, 40, 12)
    tok = np.argmax(np.asarray(rl), -1).astype(np.int32)
    assert (to_numpy(lg).argmax(-1) == tok).all()
    for _ in range(4):
        rl, rcache = rmodel.decode(rp, jnp.asarray(tok), rcache)
        lg, cache = model.decode(p, torch.from_numpy(tok), cache)
        _close(lg, rl)
        tok = np.argmax(np.asarray(rl), -1).astype(np.int32)
        assert (to_numpy(lg).argmax(-1) == tok).all()
    for k in rcache:
        _close(cache[k], rcache[k])


def test_griffin_ring_wraps_and_local_flash_spans():
    """A prompt longer than window + q_chunk: the ring holds the last W
    positions at slot q % W and the windowed prefill takes the local
    flash's span branch; prefill, cache and decode match the reference."""
    rcfg, rp, cfg, p = _smoke("recurrentgemma-2b")
    rcfg, cfg = (dataclasses.replace(c, attn_q_chunk=4) for c in (rcfg, cfg))
    s = 31
    assert s > cfg.attn_window + cfg.attn_q_chunk     # span < t: the span branch
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, size=(1, s)).astype(np.int32)
    rl, rcache = RG.prefill(rp, rcfg, jnp.asarray(toks))
    lg, cache = G.prefill(p, cfg, torch.from_numpy(toks))
    _close(lg, rl)
    for k in rcache:
        _close(cache[k], rcache[k])
    # slot q % W holds position q, for the last W positions
    w = cfg.attn_window
    assert int(s % w) != 0                       # the ring really wrapped mid-buffer
    tok = np.argmax(np.asarray(rl), -1).astype(np.int32)
    for _ in range(w + 1):                        # one full turn of the ring and more
        rl, rcache = RG.decode_step(rp, rcfg, jnp.asarray(tok), rcache)
        lg, cache = G.decode_step(p, cfg, torch.from_numpy(tok), cache)
        _close(lg, rl)
        tok = np.argmax(np.asarray(rl), -1).astype(np.int32)
        assert (to_numpy(lg).argmax(-1) == tok).all()
    _close(cache["g_k"], rcache["g_k"])


def test_encdec_encoder_above_flash_threshold_is_k4_noncausal(monkeypatch):
    """Above a lowered ``flash_threshold`` the encoder reaches K4's plain
    version (the CPU side of ``flash_prefill_op``) with causal=False, and
    matches the reference's chunked flash; at the threshold it does not."""
    rcfg, rp, cfg, p = _smoke("seamless-m4t-large-v2")
    calls = []
    real = K4OPS.flash_prefill_ref

    def spy(q, k, v, *, causal=True, q_offset=0):
        calls.append((tuple(q.shape), causal, q_offset))
        return real(q, k, v, causal=causal, q_offset=q_offset)

    monkeypatch.setattr(K4OPS, "flash_prefill_ref", spy)
    frames = np.random.RandomState(3).randn(2, 12, cfg.d_model).astype(np.float32)
    for thr, flash in ((4, True), (12, False)):
        rc, c = (dataclasses.replace(x, flash_threshold=thr) for x in (rcfg, cfg))
        calls.clear()
        want = RE.encode(rp, rc, jnp.asarray(frames))
        got = E.encode(p, c, torch.from_numpy(frames))
        _close(got, want)
        if flash:
            assert calls == [((2, 12, cfg.num_heads, cfg.head_dim), False, 0)] * \
                cfg.num_encoder_layers
        else:
            assert calls == []


# ---------------------------------------------------------------------------
# Pieces against their plain recurrences
# ---------------------------------------------------------------------------
def test_linear_scan_matches_recurrence():
    g = torch.Generator().manual_seed(0)
    for s in (1, 2, 5, 16, 37):
        a = torch.rand((2, s, 3), generator=g)
        b = torch.randn((2, s, 3), generator=g)
        pa, h = G.linear_scan(a, b)
        hh, pp = torch.zeros(2, 3), torch.ones(2, 3)
        for t in range(s):
            hh = a[:, t] * hh + b[:, t]
            pp = pp * a[:, t]
            torch.testing.assert_close(h[:, t], hh, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(pa[:, t], pp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,chunk", [(1, 4), (7, 4), (8, 8), (13, 5)])
def test_ssd_chunked_matches_recurrence(s, chunk):
    """y_t = C_t . h_t, h_t = exp(log a_t) h_{t-1} + x_t B_t^T, padded last chunk."""
    g = torch.Generator().manual_seed(s)
    b, H, P, N = 2, 3, 4, 5
    log_a = -torch.rand((b, s, H), generator=g)
    Bm, Cm = torch.randn((b, s, N), generator=g), torch.randn((b, s, N), generator=g)
    x = torch.randn((b, s, H, P), generator=g)
    h0 = torch.randn((b, H, P, N), generator=g)
    y, hf = M2._ssd_chunked(log_a, Bm, Cm, x, h0, chunk)
    h = h0.clone()
    for t in range(s):
        h = torch.exp(log_a[:, t])[:, :, None, None] * h + \
            x[:, t][..., None] * Bm[:, t][:, None, None, :]
        torch.testing.assert_close(y[:, t], torch.einsum("bhpn,bn->bhp", h, Cm[:, t]),
                                   rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(hf, h, rtol=1e-4, atol=1e-5)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(M2.softplus(x).numpy(), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Bridge and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_state_trees_bit_for_bit(arch, dtype):
    """griffin's ``groups`` / ``tail_*``, enc-dec's ``encoder`` / ``decoder``
    and mamba2's fp32 leaves cross bit for bit, in float32 and bfloat16."""
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=getattr(torch, dtype))
    rp = jax.tree.map(np.asarray, ref_get_model(rcfg).init(jax.random.PRNGKey(0)))
    p = from_reference(rp, cfg, device="cpu")
    flat_r = jax.tree_util.tree_flatten_with_path(rp)[0]
    assert len(flat_r) == len(jax.tree.leaves(p, is_leaf=torch.is_tensor))
    for path, leaf in flat_r:
        t = p
        for k in path:
            t = t[k.key]
        want = np.asarray(leaf)
        assert tuple(t.shape) == want.shape and str(t.dtype).endswith(str(want.dtype))
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_layout(arch):
    """``init_params`` (full and smoke configs' layouts): the reference's
    tree, shapes and dtypes, deterministic in the seed."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rp = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    p = get_model(cfg).init(0, "cpu")
    shapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), rp)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), p,
                        is_leaf=torch.is_tensor) == shapes
    again = get_model(cfg).init(0, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p, is_leaf=torch.is_tensor),
                                                 jax.tree.leaves(again, is_leaf=torch.is_tensor)))
    full = get_config(arch)
    assert full.family == rcfg.family and full.num_params() > 0
