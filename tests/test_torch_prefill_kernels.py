"""Port kernels K4 (flash prefill, cold and suffix mode), K5a (block gather)
and K5b (block scatter) against the reference's Pallas kernels (interpret
mode) and oracles, on the same numpy inputs.

Bars: K4 within atol = rtol = 2e-5 in float32 and 3e-2 in bfloat16 (the
reference's own K4 tolerances: the port's plain version is direct softmax,
the Pallas kernel an online softmax over tiles, so only the summation order
differs); K5a/K5b bit-exact. The CUDA kernels are held against their plain
versions on the card (``gpu`` marker); this module imports JAX only inside
the parity tests, so on a machine with the card and without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_prefill_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import layout as PL  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill_op, flash_prefill_ref  # noqa: E402
from repro_torch.kernels.kv_gather import (kv_gather, kv_gather_ref, kv_scatter,  # noqa: E402
                                           kv_scatter_ref, kv_transfer)
from repro_torch.models.bridge import to_numpy, to_torch  # noqa: E402

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels and oracles (imports JAX)."""
    import jax.numpy as jnp
    from repro.kernels import flash_prefill, kv_gather as rk
    return jnp, flash_prefill, rk


def _pair(jnp, arr: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype])
    return j, to_torch(np.asarray(j), "cpu")


def _qkv(jnp, rng, b, s, t, h, kv, hd, dtype):
    return [_pair(jnp, rng.randn(*shape), dtype)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


def _close(got, want, dtype):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# K4: flash prefill, the plain branch of the wrapper against the reference
# ---------------------------------------------------------------------------
SWEEP_FLASH = [
    # (B, S, H, KV, HD, q_blk, k_blk, causal, dtype) -- tests/test_kernels.py
    (2, 64, 4, 2, 16, 16, 16, True, "float32"),
    (1, 128, 8, 8, 32, 32, 64, True, "float32"),      # MHA
    (2, 96, 4, 1, 16, 32, 32, True, "float32"),       # MQA, uneven blocks
    (2, 64, 4, 2, 16, 16, 16, False, "float32"),
    (2, 64, 4, 2, 32, 32, 32, True, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,kv,hd,qb,kb,causal,dtype", SWEEP_FLASH)
def test_flash_prefill_matches_reference_kernel(ref, b, s, h, kv, hd, qb, kb, causal, dtype):
    jnp, rf, _ = ref
    rng = np.random.RandomState(s + hd)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(jnp, rng, b, s, s, h, kv, hd, dtype)
    want = rf.flash_prefill(qj, kj, vj, causal=causal, q_blk=qb, k_blk=kb)
    oracle = rf.flash_prefill_ref(qj, kj, vj, causal=causal)
    got = flash_prefill_op(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dtype)
    _close(got, oracle, dtype)
    assert torch.equal(got, flash_prefill_ref(qt, kt, vt, causal=causal))


@pytest.mark.parametrize("s,t,blk", [(16, 48, 16), (13, 45, 16), (48, 48, 16), (8, 72, 128)])
def test_flash_prefill_suffix_mode_matches_reference(ref, s, t, blk):
    """The suffix cases of tests/test_prefix_reuse.py: rows t-s..t of the
    full-sequence result, over the reference's padded tiles."""
    jnp, rf, _ = ref
    b, h, kv, hd = 2, 4, 2, 16
    rng = np.random.RandomState(t)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(jnp, rng, b, s, t, h, kv, hd, "float32")
    want = rf.flash_prefill_op(qj, kj, vj, q_blk=blk, k_blk=blk, q_offset=t - s)
    oracle = rf.flash_prefill_ref(qj, kj, vj, q_offset=t - s)
    got = flash_prefill_op(qt, kt, vt, q_offset=t - s)
    _close(got, want, "float32")
    _close(got, oracle, "float32")
    if s < t:                    # suffix rows == the same rows of the cold call
        q_full = torch.cat([torch.from_numpy(rng.randn(b, t - s, h, hd).astype(np.float32)),
                            qt], dim=1)
        full = flash_prefill_op(q_full, kt, vt)
        np.testing.assert_allclose(got.numpy(), full[:, t - s:].numpy(), atol=2e-6, rtol=2e-6)


def test_flash_prefill_ragged_length_matches_padded_reference(ref):
    """S = 50, which the reference's wrapper pads to its 16-row tiles."""
    jnp, rf, _ = ref
    rng = np.random.RandomState(50)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(jnp, rng, 1, 50, 50, 2, 2, 16, "float32")
    want = rf.flash_prefill_op(qj, kj, vj, q_blk=16, k_blk=16)
    _close(flash_prefill_op(qt, kt, vt), want, "float32")


def test_flash_prefill_refuses_bad_calls():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(AssertionError, match="q_offset"):
        flash_prefill_op(q, k, k, q_offset=2)
    with pytest.raises(ValueError, match="causal-only"):
        flash_prefill_op(q[:, :6], k, k, causal=False, q_offset=2)
    with pytest.raises(ValueError, match="GQA"):
        flash_prefill_op(torch.zeros(1, 8, 3, 16), k, k)


# ---------------------------------------------------------------------------
# K5a / K5b: whole-block gather and scatter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", [64, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 5, 16])
def test_kv_gather_matches_reference_kernel(ref, dtype, n, payload):
    """payload 5 gives blocks that are not a multiple of 16 bytes."""
    jnp, _, rk = ref
    rng = np.random.RandomState(n)
    pool_j, pool_t = _pair(jnp, rng.randn(32, 3, 2, payload), dtype)
    ids = rng.randint(0, 32, size=n).astype(np.int32)      # repeats allowed
    want = rk.kv_gather(pool_j, jnp.asarray(ids))
    np.testing.assert_array_equal(np.asarray(want, np.float32),
                                  np.asarray(rk.kv_gather_ref(pool_j, jnp.asarray(ids)),
                                             np.float32))
    for fn in (kv_gather, kv_gather_ref):
        got = fn(pool_t, torch.from_numpy(ids))
        assert got.dtype == pool_t.dtype
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 5, 16])
def test_kv_scatter_matches_reference_kernel(ref, dtype, n):
    jnp, _, rk = ref
    rng = np.random.RandomState(100 + n)
    pool_j, pool_t = _pair(jnp, rng.randn(32, 3, 2, 64), dtype)
    st_j, st_t = _pair(jnp, rng.randn(n, 3, 2, 64), "float32")   # cast on the way in
    ids = rng.permutation(32)[:n].astype(np.int32)
    want = rk.kv_scatter(pool_j, jnp.asarray(ids), st_j)
    oracle = rk.kv_scatter_ref(pool_j, jnp.asarray(ids), st_j)
    np.testing.assert_array_equal(np.asarray(want, np.float32), np.asarray(oracle, np.float32))
    # the plain version casts as the reference does; the wrapper is a byte
    # copy and takes staging already in the pool's dtype
    for fn, st in ((kv_scatter, st_t.to(pool_t.dtype)), (kv_scatter_ref, st_t)):
        pool = pool_t.clone()
        out = fn(pool, torch.from_numpy(ids), st)
        assert out is pool                                # in place, blocks kept
        np.testing.assert_array_equal(to_numpy(out), np.asarray(want, np.float32))


@pytest.mark.parametrize("layout", ["flowkv", "vllm"])
def test_kv_gather_scatter_roundtrip_layouts(layout):
    """gather then scatter round-trips a request's blocks on both layouts
    (VLLM pools go through the layout transform on the way in and out)."""
    spec = PL.KVCacheSpec(num_layers=3, num_blocks=16, block_size=4, num_kv_heads=2,
                          head_dim=8, dtype=torch.float32,
                          layout=PL.KVLayout.FLOWKV if layout == "flowkv" else PL.KVLayout.VLLM)
    pool = torch.from_numpy(np.random.RandomState(0).randn(*spec.shape).astype(np.float32))
    bm = pool if layout == "flowkv" else PL.vllm_to_flowkv(pool)
    src_ids = torch.tensor([2, 7, 11], dtype=torch.int32)
    dst_ids = torch.tensor([0, 5, 9], dtype=torch.int32)
    landed = kv_scatter(torch.zeros_like(bm), dst_ids, kv_gather(bm, src_ids))
    if layout == "vllm":
        landed = PL.flowkv_to_vllm(landed)
        for s, d in zip([2, 7, 11], [0, 5, 9]):
            assert torch.equal(landed[:, :, d], pool[:, :, s])
    else:
        for s, d in zip([2, 7, 11], [0, 5, 9]):
            assert torch.equal(landed[d], pool[s])
    untouched = [i for i in range(16) if i not in (0, 5, 9)]
    assert not PL.vllm_to_flowkv(landed)[untouched].any() if layout == "vllm" \
        else not landed[untouched].any()


def test_kv_scatter_refuses_duplicates_and_bad_staging():
    pool = torch.zeros(8, 2, 2, 4)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="duplicate"):
        kv_scatter(pool, torch.tensor([1, 1], dtype=torch.int32), torch.ones(2, 2, 2, 4))
    with pytest.raises(ValueError, match="staging"):
        kv_scatter(pool, ids, torch.ones(3, 2, 2, 4))
    with pytest.raises(TypeError, match="byte copy"):
        kv_scatter(pool, ids, torch.ones(2, 2, 2, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="on the host"):
        kv_scatter(pool, ids.to("meta"), torch.ones(2, 2, 2, 4))


def test_new_wrappers_refuse_other_devices():
    """A device the kernels do not take raises; it never runs the plain version."""
    q = torch.zeros(1, 8, 4, 16, device="meta")
    k = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill_op(q, k, k)
    pool = torch.zeros(8, 2, 2, 4, device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kv_gather(pool, ids)
    with pytest.raises(ValueError, match="unsupported device"):
        kv_scatter(pool, ids, torch.zeros(2, 2, 2, 4, device="meta"))


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (need an sm_90 card)
# ---------------------------------------------------------------------------
def _require_sm90():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (H100)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,KV,H", [(128, 8, 16), (256, 1, 8), (16, 2, 4)])
def test_cuda_flash_prefill_matches_plain(dtype, hd, KV, H):
    """Cold (S = T = 300) and suffix (S = 100 at q_offset 200) mode; the
    bf16 kernel against the plain version on the same values upcast to fp32
    (out within half a bf16 ulp of it) and on the bf16 values (3e-2)."""
    _require_sm90()
    g = torch.Generator(device="cuda").manual_seed(2)
    b, t, c = 2, 300, 200
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(TORCH[dtype])  # noqa: E731
    q_full, k, v = mk(b, t, H, hd), mk(b, t, KV, hd), mk(b, t, KV, hd)
    for q, off in ((q_full, 0), (q_full[:, c:], c)):
        before = (flash_prefill_op.launches, flash_prefill_op.suffix_launches)
        out = flash_prefill_op(q, k, v, q_offset=off)
        assert flash_prefill_op.launches == before[0] + 1
        assert flash_prefill_op.suffix_launches == before[1] + (1 if off else 0)
        up = flash_prefill_ref(q.float(), k.float(), v.float(), q_offset=off)
        same = flash_prefill_ref(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        err = (out.float() - up).abs()
        if dtype == "float32":
            assert float(err.max()) <= TOL["float32"]
        else:
            assert bool((err <= up.abs() * 2.0 ** -8 + 1e-5).all()), float(err.max())
            assert float((out.float() - same.float()).abs().max()) <= TOL["bfloat16"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,KV,H", [(128, 8, 16), (256, 1, 8), (16, 2, 4)])
def test_cuda_flash_prefill_suffix_rows_bit_identical(hd, KV, H, dtype):
    """Row q_offset + i of a suffix call equals that row of the cold call,
    bit for bit in each dtype, for offsets on and off the tile grid (the
    bf16 kernel also picks another block size for the short suffixes)."""
    _require_sm90()
    g = torch.Generator(device="cuda").manual_seed(3)
    t = 333
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(TORCH[dtype])  # noqa: E731
    q, k, v = mk(1, t, H, hd), mk(1, t, KV, hd), mk(1, t, KV, hd)
    cold = flash_prefill_op(q, k, v)
    for off in (1, 32, 100, 257, 332):
        suf = flash_prefill_op(q[:, off:], k, v, q_offset=off)
        torch.cuda.synchronize()
        assert torch.equal(suf, cold[:, off:]), off


@pytest.mark.gpu
@pytest.mark.parametrize("hd,G", [(hd, g) for hd in (16, 32, 64, 128, 256) for g in (1, 2, 8)]
                         + [(128, 3), (64, 64)])
def test_cuda_flash_prefill_bf16_ragged(hd, G):
    """The bf16 tensor-core kernel at every head dim and group size (G = 3
    leaves pairs of a block unused; G = 64 is the largest the wrapper
    takes), cold over a length that is no multiple of a query or key tile
    and in suffix mode at offsets off the key-tile grid: within half a bf16
    ulp (+1e-5) of the plain version on the upcast values and 3e-2 of it on
    the bf16 values, suffix rows bit-identical to the cold rows."""
    _require_sm90()
    g = torch.Generator(device="cuda").manual_seed(hd + G)
    b, t, KV = 2, 301, 2 if G <= 8 else 1
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    q_full, k, v = mk(b, t, G * KV, hd), mk(b, t, KV, hd), mk(b, t, KV, hd)
    cold = flash_prefill_op(q_full, k, v)
    for off in (0, 45, 190, 300):
        q = q_full[:, off:]
        out = cold if off == 0 else flash_prefill_op(q, k, v, q_offset=off)
        up = flash_prefill_ref(q.float(), k.float(), v.float(), q_offset=off)
        same = flash_prefill_ref(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        err = (out.float() - up).abs()
        assert bool((err <= up.abs() * 2.0 ** -8 + 1e-5).all()), (off, float(err.max()))
        assert float((out.float() - same.float()).abs().max()) <= TOL["bfloat16"], off
        assert torch.equal(out, cold[:, off:]), off


@pytest.mark.gpu
@pytest.mark.parametrize("hd,G", [(hd, g) for hd in (16, 32, 64, 128, 256) for g in (1, 2, 8, 16)]
                         + [(64, 3), (256, 64)])
def test_cuda_flash_prefill_fp32_ragged(hd, G):
    """The fp32 FMA kernel at every head dim and group size (G = 3 leaves
    pairs of a block unused; G = 64 at hd 256 takes 8-warp blocks), cold
    over 1100 keys (three key splits, ragged tiles), non-causal, and in
    suffix mode at offsets on, beside and between the split boundaries:
    within 2e-5 of the plain version, suffix rows bit-identical to the
    cold rows."""
    _require_sm90()
    g = torch.Generator(device="cuda").manual_seed(hd + G)
    b, t, KV = 2, 1100, 2 if G <= 8 else 1
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    q_full, k, v = mk(b, t, G * KV, hd), mk(b, t, KV, hd), mk(b, t, KV, hd)
    cold = flash_prefill_op(q_full, k, v)
    for off in (0, 45, 511, 512, 513, 1023, 1099):
        q = q_full[:, off:]
        out = cold if off == 0 else flash_prefill_op(q, k, v, q_offset=off)
        want = flash_prefill_ref(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        assert float((out - want).abs().max()) <= TOL["float32"], off
        assert torch.equal(out, cold[:, off:]), off
    nc = flash_prefill_op(q_full, k, v, causal=False)
    want = flash_prefill_ref(q_full, k, v, causal=False)
    torch.cuda.synchronize()
    assert float((nc - want).abs().max()) <= TOL["float32"]


@pytest.mark.gpu
def test_cuda_flash_prefill_fp32_rows_bit_identical_across_plans():
    """qwen3-1.7b's heads over 1456 keys: the cold call takes 4-warp blocks,
    the suffix calls of 400 (the chip shape), 200, 96, 8 and 1 rows other
    query tiles and grids (asserted); every suffix row equals the cold row
    bit for bit."""
    _require_sm90()
    from repro_torch.kernels.flash_prefill.ops import launch_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(6)
    t = 1456
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    q, k, v = mk(1, t, 16, 128), mk(1, t, 8, 128), mk(1, t, 8, 128)
    cold = flash_prefill_op(q, k, v)
    plans = {launch_plan(1, t, t, 16, 8, 128, True, sms)["warps"]}
    for s in (400, 200, 96, 8, 1):
        plans.add(launch_plan(1, s, t, 16, 8, 128, True, sms)["warps"])
        suf = flash_prefill_op(q[:, t - s:], k, v, q_offset=t - s)
        torch.cuda.synchronize()
        assert torch.equal(suf, cold[:, t - s:]), s
    assert len(plans) >= 2, plans


@pytest.mark.gpu
def test_cuda_flash_prefill_fp32_repeated_calls():
    """Ten calls on one stream, two multi-split inputs in turn (cold 1500
    and a suffix of 400 over 1456): each result equals that input's first,
    so every ticket is back at zero after each call."""
    _require_sm90()
    g = torch.Generator(device="cuda").manual_seed(7)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    cases = [(mk(1, 1500, 16, 128), mk(1, 1500, 8, 128), mk(1, 1500, 8, 128), 0),
             (mk(1, 400, 16, 128), mk(1, 1456, 8, 128), mk(1, 1456, 8, 128), 1056)]
    first = [flash_prefill_op(q, k, v, q_offset=off) for q, k, v, off in cases]
    for i in range(10):
        q, k, v, off = cases[i % 2]
        got = flash_prefill_op(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        assert torch.equal(got, first[i % 2]), i
    q, k, v, off = cases[1]
    assert float((first[1] - flash_prefill_ref(q, k, v, q_offset=off)).abs().max()) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_flash_prefill_scale_is_a_division(hd):
    """Both kernels scale scores by a reciprocal and one FMA correction;
    it must equal a rounded division by the fp32 sqrt(hd) on every fp32
    score that is finite and at least 2^-100 in magnitude, and on zero."""
    _require_sm90()
    from repro_torch.kernels import build

    lib = build.library()
    d = torch.tensor(float(np.sqrt(np.float32(hd), dtype=np.float32)), device="cuda")
    n = 1 << 28
    for base in range(-(1 << 31), 1 << 31, n):
        x = torch.arange(base, base + n, dtype=torch.int32, device="cuda").view(torch.float32)
        keep = torch.isfinite(x) & ((x.abs() >= 2.0 ** -100) | (x == 0))
        got = torch.empty_like(x)
        build.check(lib.flash_prefill_scale_check(x.data_ptr(), got.data_ptr(), n, hd,
                                                  torch.cuda.current_stream().cuda_stream),
                    "flash_prefill_scale_check")
        want = x / d.expand_as(x)               # elementwise div.rn on the card
        bad = int(((got != want) & keep).sum())
        assert bad == 0, (hd, base, bad)
        del x, keep, got, want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,L,payload,skew,n", [
    ("bfloat16", 4, 32 * 8 * 16, 0, 6),      # qwen3-like page, 16-byte words
    ("bfloat16", 3, 5, 0, 6),                # 60-byte blocks: 4-byte words
    ("uint8", 3, 3, 0, 6),                   # 18-byte blocks: 2-byte words
    ("uint8", 3, 3, 1, 6),                   # pool at an odd address: 1-byte words
    ("bfloat16", 28, 32 * 8 * 128, 0, 1),    # one whole qwen3-1.7b block
])
def test_cuda_kv_gather_blocks(dtype, L, payload, skew, n):
    """K5a's block copy for any block width and n = 1: bit-exact against
    the plain version, one launch of its own per call, no K1 launch."""
    _require_sm90()
    g = torch.Generator(device="cuda").manual_seed(5)
    nb = 40
    numel = nb * L * 2 * payload
    if dtype == "uint8":
        flat = torch.randint(0, 256, (numel + skew,), generator=g, device="cuda",
                             dtype=torch.uint8)
    else:
        flat = torch.randn(numel + skew, generator=g, device="cuda").to(TORCH[dtype])
    pool = flat[skew:].view(nb, L, 2, payload)
    assert pool.is_contiguous() and pool.data_ptr() % 2 == skew
    ids = torch.randint(0, nb, (n,), generator=g, device="cuda", dtype=torch.int32)
    xfer, before = kv_transfer.launches, kv_gather.launches
    got = kv_gather(pool, ids)
    assert kv_gather.launches == before + 1
    assert kv_transfer.launches == xfer
    torch.cuda.synchronize()
    assert torch.equal(got, kv_gather_ref(pool, ids))
    assert got.shape == (n, L, 2, payload) and got.is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kv_gather_scatter_bit_exact(dtype):
    _require_sm90()
    g = torch.Generator(device="cuda").manual_seed(4)
    pool = torch.randn((40, 4, 2, 32 * 8 * 16), generator=g, device="cuda").to(TORCH[dtype])
    ids = torch.tensor([3, 17, 0, 39, 17, 8], dtype=torch.int32, device="cuda")
    xfer = kv_transfer.launches
    before = kv_gather.launches
    got = kv_gather(pool, ids)
    assert kv_gather.launches == before + 1
    assert torch.equal(got, kv_gather_ref(pool, ids))
    staging = torch.randn((5, 4, 2, 32 * 8 * 16), generator=g, device="cuda").to(TORCH[dtype])
    uniq = torch.tensor([5, 0, 39, 22, 11], dtype=torch.int32)       # host ids
    a, b = pool.clone(), pool.clone()
    before = kv_scatter.launches
    assert kv_scatter(a, uniq, staging) is a
    assert kv_scatter.launches == before + 1
    kv_scatter_ref(b, uniq.cuda(), staging)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    kept = [i for i in range(40) if i not in (5, 0, 39, 22, 11)]
    assert torch.equal(a[kept], pool[kept])
    assert kv_transfer.launches == xfer              # K5 launches are their own
    with pytest.raises(ValueError, match="duplicate"):
        kv_scatter(a, ids[:5].cpu(), staging)
    with pytest.raises(ValueError, match="on the host"):
        kv_scatter(a, uniq.cuda(), staging)
    with pytest.raises(TypeError, match="byte copy"):
        kv_scatter(a, uniq, staging.float() if dtype == "bfloat16" else staging.bfloat16())
