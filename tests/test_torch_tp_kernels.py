"""The port's kernels at the shapes of tensor-parallel serving and of the
MoE / VLM configs, on the card (``gpu`` marker; skipped without an sm_90
device):

* K1 on a sharded plan's fine ``(-1, head_dim)`` rows of 128 B (hd 64 bf16)
  and 256 B (hd 64 fp32), bit-exact against its plain version; its
  small-row design at rows of 2 B to 2 KiB, aligned and unaligned bases,
  0 / 1 / a count not a multiple of a pass's rows, more rows than the grid
  holds at once, duplicate dst rows with identical bytes, untouched rows
  kept;
* K3 at granite-moe's head shapes (hd 64; 16/8, 8/4 and 4/2 heads: TP 1, 2
  and 4) and at the odd group sizes of llama4-scout (G = 5) and llava-next
  (G = 7), against its plain version, rows bit-identical alone and in a
  batch;
* K4 at hd 64 and at G = 5 and 7, both dtypes, cold and suffix, suffix rows
  bit-identical to the cold rows;
* a ``ShardedTransferEngine`` round trip 2 -> 4 -> 1 on CUDA pools, bit-exact
  against the same plans on CPU pools (the plain version), and
  ``verify_sharded_transfer`` catching one flipped element on the card.

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_tp_kernels.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.layout import KVCacheSpec  # noqa: E402
from repro_torch.core.transfer import (ShardedTransferEngine, ShardSpec,  # noqa: E402
                                       fine_page_rows, verify_sharded_transfer)
from repro_torch.kernels.flash_prefill import flash_prefill_op, flash_prefill_ref  # noqa: E402
from repro_torch.kernels.kv_gather import (kv_transfer, kv_transfer_fine,  # noqa: E402
                                           kv_transfer_ref, ops)
from repro_torch.kernels.paged_attention import (paged_decode_attention,  # noqa: E402
                                                 paged_decode_attention_stats_ref)

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _require_sm90():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (H100)")


# ---------------------------------------------------------------------------
# K1 on fine rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kv_transfer_fine_rows_bit_exact(dtype):
    """One shard pair of a 2 -> 4 plan at granite's widths (hd 64, 4 then 2
    kv-heads a shard): 128-B rows in bf16, 256-B rows in fp32."""
    g = torch.Generator(device="cuda").manual_seed(0)
    L, bs, hd, nb = 24, 32, 64, 64
    src = torch.randn((nb, L, 2, bs * 4 * hd), generator=g, device="cuda").to(TORCH[dtype])
    dst = torch.randn((nb, L, 2, bs * 2 * hd), generator=g, device="cuda").to(TORCH[dtype])
    src_blocks, dst_blocks = torch.arange(3, 17), torch.arange(40, 54)
    layer_kv = torch.arange(2 * L)
    src_pages = (src_blocks[:, None] * 2 * L + layer_kv).reshape(-1).numpy()
    dst_pages = (dst_blocks[:, None] * 2 * L + layer_kv).reshape(-1).numpy()
    sp = torch.from_numpy(fine_page_rows(src_pages, bs, 4, 2, 4)).cuda()   # heads 2..3
    dp = torch.from_numpy(fine_page_rows(dst_pages, bs, 2, 0, 2)).cuda()
    a, b, c = dst.clone(), dst.clone(), dst.clone()
    before = kv_transfer.launches, kv_transfer_fine.launches
    kv_transfer(src.view(-1, hd), a.view(-1, hd), sp, dp)
    kv_transfer_fine(src, c, sp, dp, hd)
    assert (kv_transfer.launches, kv_transfer_fine.launches) == (before[0] + 1, before[1] + 1)
    kv_transfer_ref(src.view(-1, hd), b.view(-1, hd), sp, dp)
    torch.cuda.synchronize()
    assert a.view(-1, hd).shape[1] * a.element_size() == (128 if dtype == "bfloat16" else 256)
    assert torch.equal(a, b) and torch.equal(c, b)
    assert not torch.equal(a, dst)


def _byte_rows(rows, width, offset, seed):
    """A (rows, width) uint8 pool whose base lies ``offset`` bytes past a
    256-byte aligned allocation, filled with random bytes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randint(0, 256, (rows * width + 256,), generator=g, dtype=torch.uint8,
                        device="cuda")
    return buf[offset:offset + rows * width].view(rows, width)


@pytest.mark.parametrize("width", [2, 10, 16, 64, 128, 256, 2048])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("n", [0, 1, 1031, "rows_from + 7"])
def test_cuda_kv_transfer_small_rows_bit_exact(width, offset, n):
    """The small-row design, through the wrapper (below ops.ROWS_BELOW, from
    ops.rows_from(width) rows) and forced at every width: every word width
    the bases allow, a table of 0, 1, 1031 or rows_from + 7 rows (not a multiple
    of any pass's rows), with two dst rows written twice from src rows of
    identical bytes; the rows the table does not name keep their bytes."""
    if n == "rows_from + 7":
        n = ops.rows_from(width) + 7
    src = _byte_rows(n + 500, width, offset, seed=width)
    dst = _byte_rows(n + 600, width, (offset * 3) % 8, seed=width + 1)
    chosen = ops.k1_design(width, src.data_ptr() | dst.data_ptr(), False, False, max(n, 1))
    assert chosen.design == ("rows" if width < ops.ROWS_BELOW and n >= ops.rows_from(width)
                             else "pages")
    rows = ops.rows_design(width, chosen.word, max(n, 1),
                           torch.cuda.get_device_properties(0).multi_processor_count)
    rng = np.random.RandomState(n + width)
    sp = rng.randint(0, n + 500, size=n)
    dp = rng.permutation(n + 600)[:n]
    if n > 2:                                  # duplicates: identical bytes, one dst twice
        src[int(sp[1])] = src[int(sp[0])]
        dp[1] = dp[0]
    sp_t = torch.as_tensor(sp, dtype=torch.int32, device="cuda")
    dp_t = torch.as_tensor(dp, dtype=torch.int32, device="cuda")
    want = dst.clone()
    kv_transfer_ref(src, want, sp_t, dp_t)
    before = dst.clone()
    launches = kv_transfer.launches
    kv_transfer(src, dst, sp_t, dp_t)                  # the design k1_design picks
    forced = before.clone()
    ops.kv_transfer_design(src, forced, sp_t, dp_t, rows)
    torch.cuda.synchronize()
    assert kv_transfer.launches == launches + (n > 0)
    assert torch.equal(dst, want) and torch.equal(forced, want)
    kept = torch.ones(n + 600, dtype=torch.bool, device="cuda")
    kept[dp_t.long()] = False
    assert torch.equal(dst[kept], before[kept])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kv_transfer_small_rows_stride_the_grid(dtype):
    """More fine rows than the small-row grid holds in one pass of every
    block (132 SMs x ROWS_BLOCKS_PER_SM blocks of 256 rows of 128 B), so the
    blocks stride over the table; the same table with a grid of 1 and of 7
    blocks gives the same bytes."""
    hd = 64 if dtype == "bfloat16" else 32     # 128-byte rows
    g = torch.Generator(device="cuda").manual_seed(7)
    n = 300_000
    src = torch.randn((n + 1000, hd), generator=g, device="cuda").to(TORCH[dtype])
    dst = torch.randn((n + 5000, hd), generator=g, device="cuda").to(TORCH[dtype])
    sp = torch.randperm(n + 1000, generator=g, device="cuda")[:n].to(torch.int32)
    dp = torch.randperm(n + 5000, generator=g, device="cuda")[:n].to(torch.int32)
    design = ops.k1_design(128, src.data_ptr() | dst.data_ptr(), False, False, n,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    assert design.design == "rows" and design.lanes == 8
    assert design.grid * (ops.THREADS // design.lanes) * design.in_flight < n
    want = dst.clone()
    kv_transfer_ref(src, want, sp, dp)
    for d in (design, dataclasses.replace(design, grid=1), dataclasses.replace(design, grid=7)):
        out = dst.clone()
        ops.kv_transfer_design(src, out, sp, dp, d)
        torch.cuda.synchronize()
        assert torch.equal(out, want), d


def test_cuda_kv_transfer_refuses_a_geometry_it_cannot_take():
    """The launch checks the geometry it is given: lanes not a power of two,
    a word the bases do not allow, more rows in flight than the kernel
    holds, a page grid other than one block a row (more, fewer)."""
    src = torch.zeros((8, 64), dtype=torch.bfloat16, device="cuda")
    dst = torch.zeros((8, 64), dtype=torch.bfloat16, device="cuda")
    sp = torch.arange(4, dtype=torch.int32, device="cuda")
    bad = [ops.K1Design("rows", word=16, lanes=6, grid=1),
           ops.K1Design("pages", word=16, grid=1),
           ops.K1Design("rows", word=16, lanes=8, in_flight=ops.ROWS_IN_FLIGHT + 1, grid=1),
           ops.K1Design("pages", word=16, grid=5),
           ops.K1Design("pages", word=16, grid=3)]
    src_odd = _byte_rows(8, 128, 1, seed=0)
    dst_odd = _byte_rows(8, 128, 0, seed=1)
    for d, (s, t) in zip(bad, [(src, dst), (src_odd, dst_odd), (src, dst), (src, dst),
                               (src, dst)]):
        with pytest.raises(RuntimeError, match="launch failed"):
            ops.kv_transfer_design(s, t, sp, sp, d)


# ---------------------------------------------------------------------------
# K3 at granite's shard heads and at G = 5 and 7
# ---------------------------------------------------------------------------
# (hd, KV, H): granite at TP 1 / 2 / 4, llama4-scout (G 5), llava-next (G 7)
K3_HEADS = [(64, 8, 16), (64, 4, 8), (64, 2, 4), (128, 8, 40), (128, 8, 56)]
K3_LENGTHS = [200, 0, 1, 127, 128, 129, 640, 1100, 1500, 200, 200]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,KV,H", K3_HEADS)
def test_cuda_paged_attention_tp_heads(dtype, hd, KV, H):
    g = torch.Generator(device="cuda").manual_seed(hd + H)
    bs, L, nb, W = 32, 3, 256, 64
    pool = torch.randn((nb, L, 2, bs * KV * hd), generator=g, device="cuda").to(TORCH[dtype])
    q = torch.randn((len(K3_LENGTHS), H, hd), generator=g, device="cuda").to(TORCH[dtype])
    bt = torch.randint(0, nb, (len(K3_LENGTHS), W), generator=g, device="cuda",
                       dtype=torch.int32)
    for i, n in enumerate(K3_LENGTHS):
        bt[i, -(-n // bs):] = 0
    q[-2:], bt[-2:] = q[0], bt[0]
    lens = torch.tensor(K3_LENGTHS, dtype=torch.int32, device="cuda")
    before = paged_decode_attention.launches
    o, m, l = paged_decode_attention(q, pool, 1, bt, lens, block_size=bs, return_stats=True)
    assert paged_decode_attention.launches == before + 1
    ro, rm, rl = paged_decode_attention_stats_ref(q.float(), pool[:, 1].float(), bt, lens, bs)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    assert float((o.float() - ro).abs().max()) <= tol
    assert float((m - rm).abs().max()) <= 1e-4
    assert float(((l - rl).abs() / rl.clamp(min=1e-30)).max()) <= 1e-4
    assert (o[1] == 0).all() and (l[1] == 0).all()
    for r in (0, 3, 6, 8):                       # a row alone == the row in the batch
        n_pages = max(1, -(-K3_LENGTHS[r] // bs))
        one = paged_decode_attention(q[r:r + 1], pool, 1, bt[r:r + 1, :n_pages].contiguous(),
                                     lens[r:r + 1], block_size=bs, return_stats=True)
        for a, b in zip((o, m, l), one):
            assert torch.equal(a[r:r + 1], b), r


# ---------------------------------------------------------------------------
# K4 at hd 64 and at G = 5 and 7
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,KV,H", [(64, 8, 16), (64, 2, 4), (64, 1, 5), (128, 2, 10),
                                     (128, 1, 7), (128, 2, 14)])
def test_cuda_flash_prefill_tp_heads(dtype, hd, KV, H):
    """Cold over 1100 keys and suffix at offsets off the tile grids: within
    the kernels' bars of the plain version (fp32 2e-5; bf16 half an ulp of
    the upcast values + 1e-5 and 3e-2 of the bf16 values), suffix rows
    bit-identical to the cold rows."""
    g = torch.Generator(device="cuda").manual_seed(hd + H)
    t = 1100
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(TORCH[dtype])  # noqa: E731
    q_full, k, v = mk(1, t, H, hd), mk(1, t, KV, hd), mk(1, t, KV, hd)
    cold = flash_prefill_op(q_full, k, v)
    for off in (0, 45, 513, 1099):
        q = q_full[:, off:]
        out = cold if off == 0 else flash_prefill_op(q, k, v, q_offset=off)
        if dtype == "float32":
            want = flash_prefill_ref(q, k, v, q_offset=off)
            torch.cuda.synchronize()
            assert float((out - want).abs().max()) <= 2e-5, off
        else:
            up = flash_prefill_ref(q.float(), k.float(), v.float(), q_offset=off)
            same = flash_prefill_ref(q, k, v, q_offset=off)
            torch.cuda.synchronize()
            err = (out.float() - up).abs()
            assert bool((err <= up.abs() * 2.0 ** -8 + 1e-5).all()), (off, float(err.max()))
            assert float((out.float() - same.float()).abs().max()) <= 3e-2, off
        assert torch.equal(out, cold[:, off:]), off


# ---------------------------------------------------------------------------
# The sharded transfer plane on CUDA pools
# ---------------------------------------------------------------------------
def _spec(dtype):
    return KVCacheSpec(num_layers=24, num_blocks=48, block_size=32, num_kv_heads=8,
                       head_dim=64, dtype=dtype)


def _pools(spec, tp, seed, device):
    g = torch.Generator().manual_seed(seed)
    width = spec.block_size * (spec.num_kv_heads // tp) * spec.head_dim
    return [torch.randn((spec.num_blocks, spec.num_layers, 2, width), generator=g)
            .to(spec.dtype).to(device) for _ in range(tp)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_sharded_transfer_round_trip_bit_exact(dtype):
    """2 -> 4 then 4 -> 1 on the card equals the same plans on the CPU (the
    plain version), byte for byte, in 4 + 4 launches."""
    spec = _spec(TORCH[dtype])
    heads = spec.num_kv_heads
    src_blocks, mid_blocks, end_blocks = list(range(2, 16)), list(range(30, 37)) + list(
        range(5, 12)), list(range(20, 34))
    results = {}
    for dev in ("cpu", "cuda"):
        a, b, c = _pools(spec, 2, 1, dev), _pools(spec, 4, 2, dev), _pools(spec, 1, 3, dev)
        e1 = ShardedTransferEngine(spec, spec, ShardSpec(2, heads), ShardSpec(4, heads))
        p1 = e1.plan("flowkv", src_blocks, mid_blocks)
        before = kv_transfer_fine.launches
        e1.execute(p1, a, b)
        e2 = ShardedTransferEngine(spec, spec, ShardSpec(4, heads), ShardSpec(1, heads))
        p2 = e2.plan("flowkv", mid_blocks, end_blocks)
        e2.execute(p2, b, c)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert kv_transfer_fine.launches == before + 4 + 4
            assert verify_sharded_transfer(p1, spec, a, spec, b)
            assert verify_sharded_transfer(p2, spec, b, spec, c)
        results[dev] = [x.cpu() for x in b + c]
    for x, y in zip(results["cpu"], results["cuda"]):
        assert torch.equal(x, y)


def test_cuda_verify_sharded_transfer_catches_a_flip():
    spec = _spec(torch.bfloat16)
    heads = spec.num_kv_heads
    src, dst = _pools(spec, 4, 5, "cuda"), _pools(spec, 2, 6, "cuda")
    engine = ShardedTransferEngine(spec, spec, ShardSpec(4, heads), ShardSpec(2, heads))
    plan = engine.plan("flowkv", list(range(10)), list(range(20, 30)))
    engine.execute(plan, src, dst)
    assert verify_sharded_transfer(plan, spec, src, spec, dst)
    _, dst_rows = engine.pair_rows(plan.to_descriptors(), (3, 1, 6, 8))
    flat = dst[1].view(-1, spec.head_dim)
    flat[int(dst_rows[len(dst_rows) // 2]), 5] += 1.0
    assert not verify_sharded_transfer(plan, spec, src, spec, dst)
