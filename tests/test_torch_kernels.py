"""Port kernels K1 (descriptor-table transfer), K2 (fused decode append)
and K3 (paged decode attention) against the reference's Pallas kernels
(interpret mode) and oracles, on the same numpy inputs.

Bars: K1/K2 bit-exact; K3 within atol = rtol = 1e-5 in float32 (the port
and the Pallas kernel sum in different orders). The CUDA kernels themselves
are held against their plain versions on the card (``gpu`` marker); this
module imports JAX only inside the parity tests, so on a machine with the
card and without JAX the ``gpu`` tests still run:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.block_manager import BlockManager  # noqa: E402
from repro_torch.kernels.kv_gather import (append_slot_ids, kv_append_ref,  # noqa: E402
                                           kv_append_tokens, kv_transfer,
                                           kv_transfer_ref)
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402
from repro_torch.models.bridge import to_numpy, to_torch  # noqa: E402

TOL = 1e-5
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels and oracles (imports JAX)."""
    import jax.numpy as jnp
    from repro.kernels import kv_gather, paged_attention
    return jnp, kv_gather, paged_attention


def _pair(jnp, arr: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype])
    return j, to_torch(np.asarray(j), "cpu")


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


# ---------------------------------------------------------------------------
# K1: descriptor-table transfer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_transfer_matches_reference_kernel(ref, dtype):
    jnp, rk, _ = ref
    rng = np.random.RandomState(0)
    src_j, src_t = _pair(jnp, rng.randn(10, 2, 2, 32), dtype)
    dst_j, dst_t = _pair(jnp, rng.randn(8, 2, 2, 32), dtype)
    sp = np.array([0, 13, 7, 39, 22], np.int32)          # flat page ids
    dp = np.array([31, 2, 17, 9, 0], np.int32)
    want = rk.kv_transfer(src_j, dst_j, jnp.asarray(sp), jnp.asarray(dp))
    oracle = rk.kv_transfer_ref(src_j, dst_j, jnp.asarray(sp), jnp.asarray(dp))
    out = kv_transfer(src_t, dst_t, torch.from_numpy(sp), torch.from_numpy(dp))
    assert out is dst_t                                    # in place on dst
    np.testing.assert_array_equal(_bits(out.view(torch.int16 if dtype == "bfloat16"
                                                 else torch.int32).numpy()),
                                  _bits(np.asarray(want)))
    np.testing.assert_array_equal(_bits(np.asarray(want)), _bits(np.asarray(oracle)))
    # untouched pages preserved
    flat = to_numpy(out).reshape(-1, 32)
    before = np.asarray(dst_j, np.float32).reshape(-1, 32)
    untouched = [i for i in range(before.shape[0]) if i not in dp]
    np.testing.assert_array_equal(flat[untouched], before[untouched])


def test_kv_transfer_plain_version_matches_wrapper():
    rng = np.random.RandomState(1)
    src = torch.from_numpy(rng.randn(6, 3, 2, 16).astype(np.float32))
    dst = torch.from_numpy(rng.randn(5, 3, 2, 16).astype(np.float32))
    sp = torch.tensor([3, 30, 11], dtype=torch.int32)
    dp = torch.tensor([29, 0, 4], dtype=torch.int32)
    a, b = dst.clone(), dst.clone()
    kv_transfer(src, a, sp, dp)
    kv_transfer_ref(src, b, sp, dp)
    assert torch.equal(a, b)


def test_kv_transfer_rejects_dtype_mismatch_and_aliasing():
    src = torch.zeros(4, 2, 2, 8)
    sp = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(TypeError, match="byte copy"):
        kv_transfer(src, torch.zeros(4, 2, 2, 8, dtype=torch.bfloat16), sp, sp)
    with pytest.raises(ValueError, match="share storage"):
        kv_transfer(src, src, sp, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="share storage"):
        kv_transfer(src[:2], src[2:], sp, sp)
    with pytest.raises(ValueError, match="payloads differ"):
        kv_transfer(src, torch.zeros(4, 2, 2, 16), sp, sp)


# ---------------------------------------------------------------------------
# K2: fused batched append (one K1 launch per decode step)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_append_matches_reference_with_pad_lanes(ref, dtype):
    jnp, rk, _ = ref
    nb, L, bs, KV, hd = 12, 3, 4, 2, 8
    rng = np.random.RandomState(2)
    pool_j, pool_t = _pair(jnp, rng.randn(nb, L, 2, bs * KV * hd), dtype)
    # three real lanes + one pow2 pad lane replicating lane 0
    tables = np.array([[3, 7, 0], [1, 2, 5], [9, 0, 0], [3, 7, 0]], np.int32)
    pos = np.array([5, 9, 0, 5], np.int32)
    kn = rng.randn(L, 4, KV, hd)
    vn = rng.randn(L, 4, KV, hd)
    kn[:, 3], vn[:, 3] = kn[:, 0], vn[:, 0]
    kn_j, kn_t = _pair(jnp, kn, dtype)
    vn_j, vn_t = _pair(jnp, vn, dtype)
    want = rk.kv_append_tokens(pool_j, jnp.asarray(tables), jnp.asarray(pos),
                               kn_j, vn_j, block_size=bs)
    oracle = rk.kv_append_ref(pool_j, jnp.asarray(tables), jnp.asarray(pos),
                              kn_j, vn_j, bs)
    out = kv_append_tokens(pool_t.clone(), torch.from_numpy(tables),
                           torch.from_numpy(pos), kn_t, vn_t, block_size=bs)
    plain = kv_append_ref(pool_t.clone(), torch.from_numpy(tables),
                          torch.from_numpy(pos), kn_t, vn_t, bs)
    for got in (out, plain):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(np.asarray(oracle, np.float32),
                                  np.asarray(want, np.float32))


def test_append_slot_ids_match_reference(ref):
    jnp, rk, _ = ref
    tables = np.array([[4, 1, 7], [2, 0, 0]], np.int32)
    pos = np.array([37, 3], np.int32)
    got = append_slot_ids(torch.from_numpy(tables), torch.from_numpy(pos), 5, 16)
    want = rk.append_slot_ids(jnp.asarray(tables), jnp.asarray(pos), 5, 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K3: paged decode attention with return_stats
# ---------------------------------------------------------------------------
def _tables(allocator, lengths, bs, nb, width):
    """Block tables as the given allocator lays them out for these lengths,
    zero-padded to ``width`` (after some churn so freelist tables scatter)."""
    bm = BlockManager(nb, bs, allocator)
    for rid in range(3):
        bm.allocate(100 + rid, 3 * bs)
    bm.free(101)
    rows = []
    for rid, n in enumerate(lengths):
        bm.allocate(rid, max(n, 1))
        rows.append(bm.get(rid))
    out = np.zeros((len(lengths), width), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


@pytest.mark.parametrize("allocator", ["flowkv", "freelist"])
@pytest.mark.parametrize("lengths", [[13], [9, 0, 31], [1, 40, 17, 0, 33, 8, 24, 2]])
def test_paged_attention_stats_match_reference(ref, allocator, lengths):
    jnp, _, rp = ref
    H, KV, hd, bs, L, nb = 4, 2, 16, 8, 3, 48
    width = 8                                     # padded past the longest table
    rng = np.random.RandomState(len(lengths))
    pool = rng.randn(nb, L, 2, bs * KV * hd).astype(np.float32)
    q = rng.randn(len(lengths), H, hd).astype(np.float32)
    bt = _tables(allocator, lengths, bs, nb, width)
    lens = np.array(lengths, np.int32)
    for layer in (0, L - 1):
        ro, rm, rl = rp.paged_decode_attention(jnp.asarray(q), jnp.asarray(pool[:, layer]),
                               jnp.asarray(bt), jnp.asarray(lens), block_size=bs,
                               return_stats=True)
        o, m, l = paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(pool), layer, torch.from_numpy(bt),
            torch.from_numpy(lens), block_size=bs, return_stats=True)
        np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=TOL, rtol=TOL)
    for i, n in enumerate(lengths):              # length-0 rows: out 0, m min, l 0
        if n == 0:
            assert (o[i] == 0).all() and (l[i] == 0).all()
            assert (m[i] == torch.finfo(torch.float32).min).all()


def test_paged_attention_without_stats_returns_out_only():
    rng = np.random.RandomState(3)
    pool = torch.from_numpy(rng.randn(6, 2, 2, 4 * 1 * 8).astype(np.float32))
    q = torch.from_numpy(rng.randn(1, 2, 8).astype(np.float32))
    bt = torch.tensor([[2, 4]], dtype=torch.int32)
    lens = torch.tensor([6], dtype=torch.int32)
    out = paged_decode_attention(q, pool, 1, bt, lens, block_size=4)
    full = paged_decode_attention(q, pool, 1, bt, lens, block_size=4, return_stats=True)
    assert torch.equal(out, full[0])


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (need an sm_90 card)
# ---------------------------------------------------------------------------
def _require_sm90():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (H100)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("payload", [16, 1024, 32768])
def test_cuda_kv_transfer_bit_exact(dtype, payload):
    _require_sm90()
    g = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn((20, 2, 2, payload), generator=g, device="cuda").to(TORCH[dtype])
    dst = torch.randn((30, 2, 2, payload), generator=g, device="cuda").to(TORCH[dtype])
    sp = torch.tensor([0, 13, 7, 39, 22, 22], dtype=torch.int32, device="cuda")
    dp = torch.tensor([31, 2, 17, 9, 0, 100], dtype=torch.int32, device="cuda")
    a, b = dst.clone(), dst.clone()
    before = kv_transfer.launches
    kv_transfer(src, a, sp, dp)
    assert kv_transfer.launches == before + 1
    kv_transfer_ref(src, b, sp, dp)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# (hd, KV, H): qwen3-1.7b, stablelm-12b (hd 160), gemma-2b (hd 256, G 8), the
# smoke configs (hd 16), and G = 16
K3_HEADS = [(128, 8, 16), (160, 8, 32), (256, 1, 8), (16, 2, 4), (128, 2, 32)]
# lengths on and around the split boundaries (4 pages of 32 = 128 tokens),
# a length-0 row and the whole table (12 pages); the last two rows are pad
# lanes that copy row 0
K3_LENGTHS = [200, 0, 1, 127, 128, 129, 255, 256, 257, 33, 384, 200, 200]


def _k3_case(dtype, hd, KV, H, lengths, width, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bs, L, nb = 32, 4, 160
    pool = torch.randn((nb, L, 2, bs * KV * hd), generator=g, device="cuda").to(TORCH[dtype])
    q = torch.randn((len(lengths), H, hd), generator=g, device="cuda").to(TORCH[dtype])
    bt = torch.randint(0, nb, (len(lengths), width), generator=g, device="cuda",
                       dtype=torch.int32)
    for i, n in enumerate(lengths):                # zero-pad past each row's pages
        bt[i, -(-n // bs):] = 0
    q[-2:], bt[-2:] = q[0], bt[0]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return pool, q, bt, lens, bs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,KV,H", K3_HEADS)
def test_cuda_paged_attention_matches_plain(dtype, hd, KV, H):
    _require_sm90()
    from repro_torch.kernels.paged_attention import paged_decode_attention_stats_ref
    pool, q, bt, lens, bs = _k3_case(dtype, hd, KV, H, K3_LENGTHS, 16)
    before = paged_decode_attention.launches
    o, m, l = paged_decode_attention(q, pool, 2, bt, lens, block_size=bs, return_stats=True)
    assert paged_decode_attention.launches == before + 1
    ro, rm, rl = paged_decode_attention_stats_ref(q.float(), pool[:, 2].float(), bt, lens, bs)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    assert float((o.float() - ro).abs().max()) <= tol
    assert float((m - rm).abs().max()) <= 1e-4
    assert float(((l - rl).abs() / rl.clamp(min=1e-30)).max()) <= 1e-4
    assert (o[1] == 0).all() and (l[1] == 0).all()             # the length-0 row
    assert (m[1] == torch.finfo(torch.float32).min).all()
    for x in (o, m, l):                                         # pad lanes: the same bytes
        assert torch.equal(x[-1], x[0]) and torch.equal(x[-2], x[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,KV,H", K3_HEADS)
def test_cuda_paged_attention_row_bit_identical(dtype, hd, KV, H):
    """A row's out, m and l are the same bytes alone (B=1, a table exactly
    its pages wide) and inside a batch of 13 with a table 16 pages wide."""
    _require_sm90()
    pool, q, bt, lens, bs = _k3_case(dtype, hd, KV, H, K3_LENGTHS, 16)
    full = paged_decode_attention(q, pool, 1, bt, lens, block_size=bs, return_stats=True)
    for r in (0, 1, 4, 5, 8, 10):
        n_pages = max(1, -(-K3_LENGTHS[r] // bs))
        one = paged_decode_attention(q[r:r + 1], pool, 1, bt[r:r + 1, :n_pages].contiguous(),
                                     lens[r:r + 1], block_size=bs, return_stats=True)
        for a, b in zip(full, one):
            assert torch.equal(a[r:r + 1], b), r


@pytest.mark.gpu
def test_cuda_paged_attention_reads_no_table_entry_past_the_row():
    """Table entries past a row's pages hold ids far outside the pool: the
    kernel must not read them (a read would fault) and gives the same bytes
    as with zero padding."""
    _require_sm90()
    pool, q, bt, lens, bs = _k3_case("bfloat16", 128, 8, 16, K3_LENGTHS, 16)
    far = bt.clone()
    for i, n in enumerate(K3_LENGTHS):
        far[i, -(-n // bs):] = 1 << 30
    a = paged_decode_attention(q, pool, 3, bt, lens, block_size=bs, return_stats=True)
    b = paged_decode_attention(q, pool, 3, far, lens, block_size=bs, return_stats=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_cuda_paged_attention_repeated_calls_on_one_stream():
    """Ten calls in turn on two different inputs of one shape: each result
    equals the first call on the same input, so the per-(row, kv-head)
    tickets are zero again after every call; one launch counted per call."""
    _require_sm90()
    a_in = _k3_case("float32", 128, 8, 16, K3_LENGTHS, 16, seed=2)
    b_in = _k3_case("float32", 128, 8, 16, K3_LENGTHS[::-1], 16, seed=3)

    def run(inp):
        pool, q, bt, lens, bs = inp
        return paged_decode_attention(q, pool, 0, bt, lens, block_size=bs, return_stats=True)

    want = [run(a_in), run(b_in)]
    before = paged_decode_attention.launches
    for i in range(10):
        got = run((a_in, b_in)[i % 2])
        assert all(torch.equal(x, y) for x, y in zip(got, want[i % 2])), i
    assert paged_decode_attention.launches == before + 10
