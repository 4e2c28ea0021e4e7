"""K1's host route and the device transfer verify, on the card (``gpu``
marker; every test skips without an sm_90 device). The module imports no
JAX, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_tier_kernels.py

K1 moves pages between a CUDA pool and a pinned host pool in either
direction with one launch per plan, bit-exact against ``kv_transfer_ref``;
an unpinned host pool raises. The promote (one block a page over the mapped
host pool) is also held at rows that are not a multiple of a block's pass,
at tails under 16 B and at unaligned host bases. ``verify_transfer`` on
CUDA pools gives the
verdicts the CPU version gives (which ``test_torch_faults.py`` holds against
the reference's blake2b verdicts). A host tier on a CUDA node demotes into
pinned memory and promotes back bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core import transfer as TR  # noqa: E402
from repro_torch.core.block_manager import BlockManager  # noqa: E402
from repro_torch.kernels.kv_gather import kv_transfer, kv_transfer_ref, ops  # noqa: E402
from repro_torch.serving.host_tier import TierManager  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serving.prefix_cache import TIER_DRAM, GlobalPrefixIndex  # noqa: E402

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INT = {"float32": torch.int32, "bfloat16": torch.int16}


def _require_sm90():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (H100)")


def _pools(dtype, payload, direction, seed=0):
    """(src, dst) with the GPU pool on the side ``direction`` names and the
    other in pinned host memory, filled with random bits."""
    g = torch.Generator().manual_seed(seed)
    src = torch.randn((24, 2, 2, payload), generator=g).to(TORCH[dtype])
    dst = torch.randn((30, 2, 2, payload), generator=g).to(TORCH[dtype])
    if direction == "demote":                 # card -> host
        return src.cuda(), dst.pin_memory()
    return src.pin_memory(), dst.cuda()       # promote: host -> card


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["demote", "promote"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("payload", [5, 1024, 32768])     # 5: rows not a multiple of 16 B
@pytest.mark.parametrize("n", [0, 1, 37])
def test_cuda_kv_transfer_host_route_bit_exact(direction, dtype, payload, n):
    _require_sm90()
    src, dst = _pools(dtype, payload, direction)
    rng = np.random.RandomState(n)
    sp = torch.as_tensor(rng.randint(0, 96, size=n), dtype=torch.int32).cuda()
    dp = torch.as_tensor(rng.permutation(120)[:n], dtype=torch.int32).cuda()
    want = dst.cpu().clone()
    kv_transfer_ref(src.cpu(), want, sp.cpu(), dp.cpu())
    before, dev_before = kv_transfer.host_launches, kv_transfer.launches
    out = kv_transfer(src, dst, sp, dp)
    torch.cuda.synchronize()                  # the launch is asynchronous
    assert out is dst
    assert kv_transfer.host_launches == before + (n > 0)
    assert kv_transfer.launches == dev_before
    assert torch.equal(dst.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# elements a row: 32772 B / 49156 B in fp32, 16386 B / 24578 B in bf16 (4-
# and 2-byte words, a tail past the last 4 KiB pass), one element (4 / 2 B)
# and five (20 / 10 B): tails under 16 B
@pytest.mark.parametrize("payload", [8193, 12289, 1, 5])
@pytest.mark.parametrize("offset", [0, 1])     # elements past the pinned buffer's base
def test_cuda_kv_transfer_promote_edges(dtype, payload, offset):
    """The promote at rows that are not a multiple of a block's pass of
    16-byte words, tails under 16 B and a host base off the 16-byte grid
    (the launch then takes narrower words)."""
    _require_sm90()
    rows, n = 40, 37
    g = torch.Generator().manual_seed(payload + offset)
    buf = torch.empty((rows * payload + 16,), dtype=TORCH[dtype], pin_memory=True)
    buf.copy_(torch.randn(buf.shape, generator=g).to(TORCH[dtype]))
    src = buf[offset:offset + rows * payload].view(rows, payload)
    assert src.is_pinned()
    dst = torch.randn((50, payload), generator=g).to(TORCH[dtype]).cuda()
    design = ops.k1_design(payload * src.element_size(), src.data_ptr() | dst.data_ptr(),
                           True, False, n)
    assert design.design == "pages"
    rng = np.random.RandomState(payload)
    sp = torch.as_tensor(rng.randint(0, rows, size=n), dtype=torch.int32).cuda()
    dp = torch.as_tensor(rng.permutation(50)[:n], dtype=torch.int32).cuda()
    want = dst.cpu().clone()
    kv_transfer_ref(src, want, sp.cpu(), dp.cpu())
    before = kv_transfer.host_launches
    kv_transfer(src, dst, sp, dp)
    torch.cuda.synchronize()
    assert kv_transfer.host_launches == before + 1
    assert torch.equal(dst.cpu().view(INT[dtype]), want.view(INT[dtype]))


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["demote", "promote"])
def test_cuda_kv_transfer_refuses_unpinned_host_pool(direction):
    _require_sm90()
    src, dst = _pools("float32", 64, direction)
    if direction == "demote":
        dst = dst.cpu().clone()               # a pageable copy
        assert not dst.is_pinned()
    else:
        src = src.cpu().clone()
        assert not src.is_pinned()
    sp = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    dp = torch.tensor([3, 4], dtype=torch.int32, device="cuda")
    before = kv_transfer.host_launches
    with pytest.raises(ValueError, match="pinned"):
        kv_transfer(src, dst, sp, dp)
    with pytest.raises(ValueError, match="page tables"):    # tables off the card
        kv_transfer(*_pools("float32", 64, direction), sp.cpu(), dp.cpu())
    assert kv_transfer.host_launches == before


def _verify_pools(dtype, case):
    """CPU pools after one clean transfer, then one change (the five cases
    of ``test_torch_faults.py``)."""
    spec = L.KVCacheSpec(num_layers=3, num_blocks=16, block_size=4, num_kv_heads=2,
                         head_dim=8, dtype=TORCH[dtype])
    engine = TR.TransferEngine(spec)
    plan = engine.planner.plan("flowkv", [0, 1, 2], [5, 6, 9])
    src = torch.randn(spec.shape, generator=torch.Generator().manual_seed(3)).to(TORCH[dtype])
    dst = torch.zeros(spec.shape, dtype=TORCH[dtype])
    engine.execute(plan, src, dst)
    table = plan.to_descriptors()
    s_bits = src.view(-1, spec.payload).view(INT[dtype])
    d_bits = dst.view(-1, spec.payload).view(INT[dtype])
    page = int(table.page_ids(spec, "dst")[3])
    src_page = int(table.page_ids(spec, "src")[3])
    outside = next(p for p in range(d_bits.shape[0]) if p not in set(table.page_ids(spec, "dst")))
    sign = torch.tensor(-(2 ** (8 * d_bits.element_size() - 1)), dtype=INT[dtype])
    nan = torch.tensor(0x7FC00001 if dtype == "float32" else 0x7FC1, dtype=INT[dtype])
    if case == "inside":
        d_bits[page, 1] ^= 1
    elif case == "outside":
        d_bits[outside, 1] ^= 1
    elif case == "nan":
        s_bits[src_page, 1] = nan
        d_bits[page, 1] = nan
    elif case == "signed_zero":
        s_bits[src_page, 1] = 0
        d_bits[page, 1] = sign
    return spec, plan, src, dst


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,want", [("clean", True), ("inside", False), ("outside", True),
                                       ("nan", True), ("signed_zero", False)])
def test_cuda_verify_transfer_verdicts(dtype, case, want):
    _require_sm90()
    spec, plan, src, dst = _verify_pools(dtype, case)
    assert TR.verify_transfer(plan, spec, src, spec, dst) == want
    assert TR.verify_transfer(plan, spec, src.cuda(), spec, dst.cuda()) == want


@pytest.mark.gpu
def test_cuda_host_tier_roundtrip_bit_identical():
    """Demote into pinned memory, scribble over the vacated pool blocks,
    promote back: the pages are bit-identical, one host launch each way."""
    _require_sm90()
    spec = L.KVCacheSpec(num_layers=2, num_blocks=8, block_size=4, num_kv_heads=2,
                         head_dim=8, dtype=torch.float32)
    kv = PagedKVCache(spec, device="cuda")
    bm = BlockManager(spec.num_blocks, spec.block_size)
    index = GlobalPrefixIndex(spec.block_size)
    bm.on_free = lambda blocks: index.invalidate_blocks(0, blocks)
    tm = TierManager(0, bm, index, spec, host_blocks=8, kv=kv).attach()
    assert tm.host.pool.is_pinned()
    prompt = list(range(12))
    blocks = bm.allocate(1, len(prompt))
    index.insert(0, prompt, blocks)
    kv.pool.copy_(torch.arange(kv.pool.numel(), dtype=torch.float32).view(spec.shape))
    want = kv.pool[torch.as_tensor(blocks, device="cuda")].cpu()
    before = kv_transfer.host_launches
    bm.free(1)
    bm.reclaim_cache()
    assert index.lookup(0, prompt).tiers == [TIER_DRAM] * 3
    torch.cuda.synchronize()                  # before the CPU reads the host pool
    host_blocks = sorted(index._node_host_blocks[0])
    assert torch.equal(tm.host.pool[host_blocks], want)
    kv.pool[torch.as_tensor(blocks, device="cuda")] = -1.0
    assert tm.promote_match(prompt) == 3
    m = index.lookup(0, prompt)
    torch.cuda.synchronize()
    assert torch.equal(kv.pool[torch.as_tensor(m.block_ids, device="cuda")].cpu(), want)
    assert kv_transfer.host_launches == before + 2
    assert tm.demote_dispatches == tm.promote_dispatches == 1
    tm.check_invariants()
