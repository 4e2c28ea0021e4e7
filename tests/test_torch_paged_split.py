"""The split arithmetic of the port's K3 CUDA kernel, on the CPU.

``ref.paged_decode_attention_split_ref`` computes what the kernel computes:
one fp32 partial per run of ``pages_per_split`` pages counted from page 0,
combined in split order. It is held here against the reference's Pallas
kernel (interpret mode) on the same numpy inputs, within atol = rtol = 1e-5
(the two sum in different orders), at lengths on and around the split
boundaries, on both allocators' tables, padded table widths and length 0;
and a row's result is held bit-identical wherever the row sits in a batch
and whatever the table width. The CUDA kernel itself is held against the
plain version on the card (``gpu`` tests in ``test_torch_kernels.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.block_manager import BlockManager  # noqa: E402
from repro_torch.kernels.paged_attention.ops import PAGES_PER_SPLIT  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    NEG_INF, paged_decode_attention_split_ref)

TOL = 1e-5
H, KV, HD, BS, NB, WIDTH = 4, 2, 16, 8, 96, 8
# lengths at 0, 1, k*split - 1, k*split, k*split + 1 for splits of 2 pages
# (16 tokens) and of 4 (32), and the whole table (WIDTH * BS = 64)
BOUNDARY = [0, 1, 15, 16, 17, 31, 32, 33, 47, 48, 63, 64]


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from repro.kernels import paged_attention
    return jnp, paged_attention


def _tables(allocator, lengths, width):
    """Block tables as the allocator lays them out (after some churn so
    freelist tables scatter), zero-padded to ``width``."""
    bm = BlockManager(NB, BS, allocator)
    for rid in range(3):
        bm.allocate(100 + rid, 3 * BS)
    bm.free(101)
    out = np.zeros((len(lengths), width), np.int32)
    for rid, n in enumerate(lengths):
        bm.allocate(rid, max(n, 1))
        row = bm.get(rid)
        out[rid, :len(row)] = row
    return out


@pytest.mark.parametrize("allocator", ["flowkv", "freelist"])
@pytest.mark.parametrize("lengths", [[13], [9, 0, 31], [1, 40, 17, 0, 33, 8, 24, 2], BOUNDARY])
def test_split_ref_matches_reference_kernel(ref, allocator, lengths):
    jnp, rp = ref
    rng = np.random.RandomState(len(lengths) + 7)
    pages = rng.randn(NB, 2, BS * KV * HD).astype(np.float32)
    q = rng.randn(len(lengths), H, HD).astype(np.float32)
    bt = _tables(allocator, lengths, WIDTH)
    lens = np.array(lengths, np.int32)
    ro, rm, rl = rp.paged_decode_attention(jnp.asarray(q), jnp.asarray(pages), jnp.asarray(bt),
                                           jnp.asarray(lens), block_size=BS, return_stats=True)
    for pps in sorted({1, 2, PAGES_PER_SPLIT}):
        o, m, l = paged_decode_attention_split_ref(
            torch.from_numpy(q), torch.from_numpy(pages), torch.from_numpy(bt),
            torch.from_numpy(lens), BS, pps)
        np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=TOL, rtol=TOL)
        for i, n in enumerate(lengths):          # length 0: out 0, m finfo.min, l 0
            if n == 0:
                assert (o[i] == 0).all() and (l[i] == 0).all() and (m[i] == NEG_INF).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pps", [2, PAGES_PER_SPLIT])
def test_split_ref_row_bit_identical_across_batch_and_width(dtype, pps):
    """Row 3 alone (B=1, a table exactly its pages wide) and inside a batch
    of 8 with a table twice as wide and two pad lanes that copy it: the same
    bytes of out, m and l."""
    rng = np.random.RandomState(11)
    pages = torch.from_numpy(rng.randn(NB, 2, BS * KV * HD).astype(np.float32)).to(dtype)
    lengths = [5, 64, 0, 49, 33, 16, 49, 49]              # lanes 6, 7 pad row 3
    bt = _tables("freelist", lengths, 2 * WIDTH)
    bt[6:] = bt[3]
    q = torch.from_numpy(rng.randn(8, H, HD).astype(np.float32)).to(dtype)
    q[6:] = q[3]
    lens = torch.tensor(lengths, dtype=torch.int32)
    full = paged_decode_attention_split_ref(q, pages, torch.from_numpy(bt), lens, BS, pps)
    n_pages = -(-lengths[3] // BS)
    one = paged_decode_attention_split_ref(q[3:4], pages, torch.from_numpy(bt[3:4, :n_pages]),
                                           lens[3:4], BS, pps)
    for a, b in zip(full, one):
        assert torch.equal(a[3:4], b)
        assert torch.equal(a[6], a[3]) and torch.equal(a[7], a[3])


def test_split_ref_ignores_table_entries_past_the_row():
    """Entries past a row's pages (zero padding, or any block id) are never
    read: filling them with other ids changes nothing."""
    rng = np.random.RandomState(5)
    pages = torch.from_numpy(rng.randn(NB, 2, BS * KV * HD).astype(np.float32))
    lengths = [17, 0, 40]
    bt = _tables("flowkv", lengths, WIDTH)
    other = bt.copy()
    for i, n in enumerate(lengths):
        other[i, -(-n // BS):] = rng.randint(0, NB, WIDTH - -(-n // BS))
    q = torch.from_numpy(rng.randn(3, H, HD).astype(np.float32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    a = paged_decode_attention_split_ref(q, pages, torch.from_numpy(bt), lens, BS, 2)
    b = paged_decode_attention_split_ref(q, pages, torch.from_numpy(other), lens, BS, 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
