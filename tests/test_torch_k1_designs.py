"""K1's design choice and launch geometry (``kernels/kv_gather/ops.py``),
and ``kv_transfer_fine``'s plain path against the reference's Pallas K1.

``k1_design`` is a pure function of the row width, the table's length, the
bases' alignment and which pool lies in pinned host memory; the CUDA launch
takes its result as it is. Here, on the CPU: it picks the small-row design
for the 128 B fine rows of a TP 2 -> 4 transfer, and one block a row for
64 KiB pages, for the decode appends' short tables and for the host tier's
demote and promote; and a numpy model of each kernel's mapping of threads
to bytes (a mirror of the loops in ``csrc/kv_transfer.cu``) covers every
byte of every named row exactly once under the geometry it returns, at row
widths of 1 B to 128 KiB, with every limit the launch checks held. The
models run over seeded random cases, and over hypothesis's where it is
installed. The kernels themselves are held bit-exact on the card
(``test_torch_tp_kernels.py``, ``test_torch_tier_kernels.py``; ``gpu``
marker).

``kv_transfer_fine`` on CPU tensors (its plain version) equals the
reference's ``kv_transfer`` in interpret mode on the same fine
``(-1, head_dim)`` row views, bit for bit, at hd 16, 64 and 256.
"""
import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

torch = pytest.importorskip("torch")

from repro_torch.kernels.kv_gather import kv_transfer_fine, ops  # noqa: E402
from repro_torch.models.bridge import to_torch  # noqa: E402

UNROLL = 4                 # the pages kernel's kUnroll


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The choice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("row_bytes,src_on_host,dst_on_host,n,want", [
    (128, False, False, 144_384, "rows"),      # TP 2 -> 4 fine rows (granite bf16 hd 64)
    (256, False, False, 5000, "rows"),         # fine rows in fp32
    (65536, False, False, 1792, "pages"),      # the P->D transfer's and K5b's pages
    (2048, False, False, 448, "pages"),        # qwen3-1.7b's bf16 decode append, B = 8
    (1024, False, False, 192, "pages"),        # granite's bf16 decode append, B = 4
    (512, False, False, 48, "pages"),          # a TP 2 shard's append, B = 1
    (131072, True, False, 1848, "pages"),      # the host tier's promote
    (128, True, False, 144_384, "pages"),      # a pinned source keeps one block a row
    (131072, False, True, 1848, "pages"),      # the host tier's demote
])
def test_k1_design_picks(row_bytes, src_on_host, dst_on_host, n, want):
    d = ops.k1_design(row_bytes, 0, src_on_host, dst_on_host, n, 132)
    assert d.design == want
    assert d.word == 16
    if want == "rows":
        assert d.lanes == row_bytes // 16 and d.grid <= 132 * ops.ROWS_BLOCKS_PER_SM
    if want == "pages":
        assert d == ops.block_a_row(row_bytes, 0, n) and d.grid == n


def test_k1_design_thresholds_and_words():
    """The threshold row width and table length split rows from pages; the
    word follows the alignment of both bases and of the row width."""
    for w in (16, 128, 256, 257, 512, 1024, ops.ROWS_BELOW - 16):
        from_ = ops.rows_from(w)
        assert from_ == ops.ROWS_FROM * max(1, -(-w // ops.ROWS_FROM_UNIT))
        assert ops.k1_design(w, 0, False, False, from_).design == "rows"
        assert ops.k1_design(w, 0, False, False, from_ - 1).design == "pages"
    assert ops.rows_from(256) == ops.ROWS_FROM < ops.rows_from(257) == 2 * ops.ROWS_FROM
    assert ops.k1_design(ops.ROWS_BELOW, 0, False, False, 10 ** 6).design == "pages"
    n = ops.ROWS_FROM
    assert ops.k1_design(128, 0x1000 | 0x2008, False, False, n).word == 4
    assert ops.k1_design(10, 0, False, False, n).word == 2
    assert ops.k1_design(128, 1, False, False, n).word == 1
    assert ops.k1_design(128, 1, False, False, 10).word == 1       # one block a row too
    assert ops.k1_design(128, 0, False, False, n, 132).in_flight == 1     # a short table


# ---------------------------------------------------------------------------
# A numpy model of each kernel's mapping
# ---------------------------------------------------------------------------
def _limits(d: ops.K1Design, row_bytes: int, align: int, n: int) -> None:
    """What ``kv_transfer_launch`` checks before it launches."""
    assert d.grid >= 1
    if d.design == "pages":
        assert d.grid == n
    assert d.word in (16, 4, 2, 1) and (align | row_bytes) % d.word == 0
    if d.design == "rows":
        assert d.lanes in (1, 2, 4, 8, 16, 32)
        assert 1 <= d.in_flight <= ops.ROWS_IN_FLIGHT


def _cover_pages(d, n, row_bytes):
    words = row_bytes // d.word
    count = np.zeros((n, words), np.int32)
    step = ops.THREADS * UNROLL
    for i in range(d.grid):                   # block i copies row i
        for t in range(ops.THREADS):
            base = t
            while base + (UNROLL - 1) * ops.THREADS < words:
                count[i, base:base + UNROLL * ops.THREADS:ops.THREADS] += 1
                base += step
            count[i, base:words:ops.THREADS] += 1
    return count


def _cover_rows(d, n, row_bytes):
    words = row_bytes // d.word
    count = np.zeros((n, words), np.int32)
    groups = ops.THREADS // d.lanes
    tile = groups * d.in_flight
    lane_words = np.zeros(words, np.int32)
    for lane in range(d.lanes):
        lane_words[lane::d.lanes] += 1
    for b in range(d.grid):
        for base in range(b * tile, n, d.grid * tile):
            for q in range(groups):
                for k in range(ops.ROWS_IN_FLIGHT):
                    r = base + q + k * groups
                    if k < d.in_flight and r < n:
                        count[r] += lane_words
    return count


def _pages_case(row_bytes, n, align, src_on_host, dst_on_host):
    """A pages launch: wide rows between card pools, or either host side."""
    d = ops.k1_design(row_bytes, align, src_on_host, dst_on_host, n)
    assert d.design == "pages"
    _limits(d, row_bytes, align, n)
    assert (_cover_pages(d, n, row_bytes) == 1).all()


def _rows_case(row_bytes, n, align, sms):
    """The small-row geometry at any table length (the kernel takes any);
    ``k1_design`` returns it from ``rows_from(row_bytes)`` rows."""
    n = min(n, max(1, 2_000_000 // row_bytes))
    word = ops.block_a_row(row_bytes, align, n).word
    d = ops.rows_design(row_bytes, word, n, sms)
    if n >= ops.rows_from(row_bytes):
        assert ops.k1_design(row_bytes, align, False, False, n, sms) == d
    _limits(d, row_bytes, align, n)
    assert (_cover_rows(d, n, row_bytes) == 1).all()


@pytest.mark.parametrize("seed", range(4))
def test_geometries_cover_every_row_once_seeded(seed):
    """Seeded random cases of the three models below, hypothesis or not."""
    rng = np.random.RandomState(seed)
    for _ in range(3):
        _pages_case(int(rng.randint(ops.ROWS_BELOW, 131073)), int(rng.randint(1, 13)),
                    int(rng.randint(0, 64)), False, bool(rng.randint(2)))
        _rows_case(int(rng.randint(1, ops.ROWS_BELOW)), int(rng.randint(1, 3001)),
                   int(rng.randint(0, 64)), int(rng.randint(1, 133)))
        row_bytes = int(rng.randint(1, 131073))
        _pages_case(row_bytes, int(rng.randint(1, min(40, max(1, 3_000_000 // row_bytes)) + 1)),
                    int(rng.randint(0, 32)), True, False)


if HAVE_HYPOTHESIS:
    @settings(max_examples=40, deadline=None)
    @given(row_bytes=st.integers(ops.ROWS_BELOW, 131072), n=st.integers(1, 12),
           align=st.integers(0, 63), dst_on_host=st.booleans())
    def test_pages_geometry_covers_every_row_once(row_bytes, n, align, dst_on_host):
        _pages_case(row_bytes, n, align, False, dst_on_host)

    @settings(max_examples=60, deadline=None)
    @given(row_bytes=st.integers(1, ops.ROWS_BELOW - 1), n=st.integers(1, 3000),
           align=st.integers(0, 63), sms=st.integers(1, 132))
    def test_rows_geometry_covers_every_row_once(row_bytes, n, align, sms):
        _rows_case(row_bytes, n, align, sms)

    @settings(max_examples=60, deadline=None)
    @given(row_bytes=st.integers(1, 131072), n=st.integers(1, 40), align=st.integers(0, 31))
    def test_host_geometry_covers_every_row_once(row_bytes, n, align):
        """The promote from a pinned source: one block a row at any width."""
        _pages_case(row_bytes, min(n, max(1, 3_000_000 // row_bytes)), align, True, False)


# ---------------------------------------------------------------------------
# kv_transfer_fine's plain path vs the reference's Pallas K1 (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64, 256])
def test_kv_transfer_fine_matches_reference_kernel(hd, dtype):
    import jax.numpy as jnp
    from repro.kernels import kv_gather as rk

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    rng = np.random.RandomState(hd)
    src_np = rng.randn(6, 2, 2, 4 * hd)                   # 4 rows of hd a page
    dst_np = rng.randn(5, 2, 2, 2 * hd)                   # 2 rows of hd a page
    src_j, dst_j = jnp.asarray(src_np, jdt), jnp.asarray(dst_np, jdt)
    src_t = to_torch(np.asarray(src_j), "cpu")
    dst_t = to_torch(np.asarray(dst_j), "cpu")
    n = 24
    sp = rng.randint(0, src_t.numel() // hd, size=n).astype(np.int32)
    dp = rng.permutation(dst_t.numel() // hd)[:n].astype(np.int32)
    want = rk.kv_transfer(src_j.reshape(-1, hd), dst_j.reshape(-1, hd), jnp.asarray(sp),
                          jnp.asarray(dp), interpret=True)
    before = kv_transfer_fine.launches
    out = kv_transfer_fine(src_t, dst_t, torch.from_numpy(sp), torch.from_numpy(dp), hd)
    assert out is dst_t and kv_transfer_fine.launches == before    # the plain path
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(out.view(-1, hd).view(bits).numpy(),
                                  np.asarray(want).view(np.int16 if dtype == "bfloat16"
                                                        else np.int32))
    untouched = np.setdiff1d(np.arange(dst_t.numel() // hd), dp)
    np.testing.assert_array_equal(out.view(-1, hd)[untouched].view(bits).numpy(),
                                  np.asarray(dst_j.reshape(-1, hd))[untouched].view(
                                      np.int16 if dtype == "bfloat16" else np.int32))
