"""The port's transfer plane against the reference: the same plans on the
same numpy pools must land bit-exact destination pools, with equal
``num_calls`` / ``num_dispatches``, for all three schedules, FLOWKV<->VLLM
layouts, heterogeneous pool sizes and layer-window sub-plans; payload
digests must equal the reference's byte for byte."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import layout as RL  # noqa: E402
from repro.core import transfer as RTR  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core import transfer as TR  # noqa: E402
from repro_torch.models.bridge import to_torch  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _specs(layout="flowkv", dtype="float32", layers=3, blocks=24):
    kw = dict(num_layers=layers, num_blocks=blocks, block_size=4, num_kv_heads=2,
              head_dim=8)
    return (RL.KVCacheSpec(**kw, dtype=JNP[dtype], layout=RL.KVLayout(layout)),
            L.KVCacheSpec(**kw, dtype=TORCH[dtype], layout=L.KVLayout(layout)))


def _pool(spec_ref, seed):
    arr = jnp.asarray(np.random.RandomState(seed).randn(*spec_ref.shape), spec_ref.dtype)
    return arr, to_torch(np.asarray(arr), "cpu")


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


LAYOUTS = [("flowkv", "flowkv"), ("flowkv", "vllm"), ("vllm", "flowkv")]
# the flowkv schedule plans over a FLOWKV source only (see the next test)
CASES = [(s, a, b) for s in ("flowkv", "layerwise", "blockwise") for a, b in LAYOUTS
         if not (s == "flowkv" and a != "flowkv")]


def test_flowkv_schedule_requires_flowkv_layout():
    _, spec = _specs("vllm")
    with pytest.raises(ValueError):
        TR.TransferPlanner(spec).plan_flowkv([0], [0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule,src_layout,dst_layout", CASES)
def test_transfer_bit_exact_and_counts(schedule, src_layout, dst_layout, dtype):
    rs_spec, s_spec = _specs(src_layout, dtype)
    rd_spec, d_spec = _specs(dst_layout, dtype, blocks=40)     # heterogeneous sizes
    src_j, src_t = _pool(rs_spec, 7)
    dst_j, dst_t = _pool(rd_spec, 8)
    sb, db = [3, 4, 5, 11, 12], [31, 2, 17, 8, 9]
    want, rplan, _ = RTR.transfer_request(rs_spec, src_j, sb, rd_spec, dst_j, db, schedule)
    got, plan, _ = TR.transfer_request(s_spec, src_t, sb, d_spec, dst_t, db, schedule)
    assert got is dst_t                                   # landed in place
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert plan.num_calls == rplan.num_calls
    assert plan.num_dispatches == rplan.num_dispatches == 1
    assert plan.total_bytes == rplan.total_bytes
    rt, t = rplan.to_descriptors(), plan.to_descriptors()
    for side, rspec, spec in (("src", rs_spec, s_spec), ("dst", rd_spec, d_spec)):
        np.testing.assert_array_equal(t.page_ids(spec, side), rt.page_ids(rspec, side))


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("schedule", ["flowkv", "layerwise", "blockwise"])
def test_layer_window_subplans(schedule, window):
    rspec, spec = _specs(layers=5)
    src_j, src_t = _pool(rspec, 1)
    dst_j, dst_t = _pool(rspec, 2)
    sb, db = [1, 2, 3, 9], [20, 21, 4, 10]
    rplan = RTR.TransferPlanner(rspec).plan(schedule, sb, db)
    plan = TR.TransferPlanner(spec).plan(schedule, sb, db)
    rsubs, subs = rplan.split_layer_windows(window), plan.split_layer_windows(window)
    assert [s.layer_span for s in subs] == [s.layer_span for s in rsubs]
    assert [s.num_calls for s in subs] == [s.num_calls for s in rsubs]
    assert [s.total_bytes for s in subs] == [s.total_bytes for s in rsubs]
    rengine, engine = RTR.TransferEngine(rspec), TR.TransferEngine(spec)
    for rsub, sub in zip(rsubs, subs):
        dst_j = rengine.execute(rsub, src_j, dst_j)
        engine.execute(sub, src_t, dst_t)
        np.testing.assert_array_equal(_bits(dst_t), _bits(dst_j))
    assert engine.num_dispatches == rengine.num_dispatches == len(subs)


def test_every_schedule_is_one_dispatch_and_empty_plan_is_none():
    _, spec = _specs()
    src = torch.randn(spec.shape)
    for schedule in ("layerwise", "blockwise", "flowkv"):
        engine = TR.TransferEngine(spec)
        plan = engine.planner.plan(schedule, [1, 2, 3, 9, 15], [20, 21, 22, 4, 10])
        before = TR.total_dispatches()
        engine.execute(plan, src, torch.zeros(spec.shape))
        assert TR.total_dispatches() - before == 1
        assert engine.num_dispatches == plan.num_dispatches == 1
    engine = TR.TransferEngine(spec)
    empty = engine.planner.plan_blockwise([], [])
    dst = torch.ones(spec.shape)
    engine.execute(empty, src, dst)
    assert engine.num_dispatches == 0 and empty.num_dispatches == 0
    assert bool((dst == 1).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["flowkv", "vllm"])
def test_payload_digest_equals_reference(layout, dtype):
    rspec, spec = _specs(layout, dtype)
    pool_j, pool_t = _pool(rspec, 3)
    pages = np.array([5, 0, 17, 60, 33], np.int32)
    assert TR.payload_digest(pool_t, spec, pages) == RTR.payload_digest(pool_j, rspec, pages)


def test_verify_transfer_catches_corruption():
    rspec, spec = _specs()
    _, src = _pool(rspec, 4)
    dst = torch.zeros(spec.shape)
    engine = TR.TransferEngine(spec)
    plan = engine.planner.plan("flowkv", [0, 1, 2], [5, 6, 9])
    engine.execute(plan, src, dst)
    assert TR.verify_transfer(plan, spec, src, spec, dst)
    dst.view(-1, spec.payload)[int(plan.to_descriptors().page_ids(spec, "dst")[3]), 0] += 1.0
    assert not TR.verify_transfer(plan, spec, src, spec, dst)


def test_planner_counts_match_reference_at_paper_scale():
    """Table-3 call counts (llama31-8b, 11.7k tokens) from both planners."""
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    rcfg, cfg = ref_get_config("llama31-8b"), get_config("llama31-8b")
    kw = dict(num_layers=cfg.num_layers, num_blocks=8192, block_size=cfg.block_size,
              num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim)
    rspec = RL.KVCacheSpec(**kw, dtype=rcfg.dtype)
    spec = L.KVCacheSpec(**kw, dtype=cfg.dtype)
    assert spec.bytes_per_block == rspec.bytes_per_block
    ids = list(range(spec.blocks_for_tokens(11700)))
    scattered = ids[::-1]
    for schedule in ("layerwise", "blockwise", "flowkv"):
        for dst in (ids, scattered):
            a = TR.TransferPlanner(spec).plan(schedule, ids, dst)
            b = RTR.TransferPlanner(rspec).plan(schedule, ids, dst)
            assert (a.num_calls, a.total_bytes, a.num_dispatches) == \
                (b.num_calls, b.total_bytes, b.num_dispatches)


# ---------------------------------------------------------------------------
# Layouts and the paged pool (core/layout.py, serving/kv_cache.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["flowkv", "vllm"])
def test_layout_ops_match_reference(layout):
    rspec, spec = _specs(layout, blocks=10)
    assert spec.shape == rspec.shape and spec.payload == rspec.payload
    assert spec.bytes_per_block == rspec.bytes_per_block
    assert spec.transfer_calls_per_block() == rspec.transfer_calls_per_block()
    other = "vllm" if layout == "flowkv" else "flowkv"
    pool_j, pool_t = _pool(rspec, 5)
    conv_j = RL.convert(pool_j, RL.KVLayout(layout), RL.KVLayout(other))
    conv_t = L.convert(pool_t, L.KVLayout(layout), L.KVLayout(other))
    np.testing.assert_array_equal(_bits(conv_t), _bits(conv_j))
    rng = np.random.RandomState(6)
    kp = rng.randn(4, 2, 8).astype(np.float32)
    vp = rng.randn(4, 2, 8).astype(np.float32)
    w_j = RL.write_block(pool_j, rspec, 7, 1, jnp.asarray(kp), jnp.asarray(vp))
    w_t = L.write_block(pool_t, spec, 7, 1, torch.from_numpy(kp), torch.from_numpy(vp))
    np.testing.assert_array_equal(_bits(w_t), _bits(w_j))
    for a, b in zip(L.read_block(w_t, spec, 7, 1), RL.read_block(w_j, rspec, 7, 1)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    ids = [2, 7, 9]
    g_j = RL.gather_blocks(w_j, rspec, ids)
    g_t = L.gather_blocks(w_t, spec, ids)
    np.testing.assert_array_equal(_bits(g_t), _bits(g_j))
    s_j = RL.scatter_blocks(RL.alloc_cache(rspec), rspec, [0, 4, 5], g_j)
    s_t = L.scatter_blocks(L.alloc_cache(spec, "cpu"), spec, [0, 4, 5], g_t)
    np.testing.assert_array_equal(_bits(s_t), _bits(s_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kv_cache_matches_reference(dtype):
    """The same writes and appends on the same K/V leave bit-identical pools."""
    from repro.models.common import ModelConfig as RefConfig
    from repro.serving.kv_cache import PagedKVCache as RefCache
    from repro.serving.kv_cache import spec_for_model as ref_spec_for
    from repro_torch.models.common import ModelConfig
    from repro_torch.serving.kv_cache import PagedKVCache, spec_for_model

    kw = dict(name="t", family="dense", num_layers=3, d_model=32, vocab_size=16,
              num_heads=4, num_kv_heads=2, head_dim=8, block_size=4)
    rkv = RefCache(ref_spec_for(RefConfig(**kw, dtype=JNP[dtype]), 16))
    kv = PagedKVCache(spec_for_model(ModelConfig(**kw, dtype=TORCH[dtype]), 16),
                      device="cpu")
    rng = np.random.RandomState(9)

    def same(x):
        j = jnp.asarray(x, JNP[dtype])
        return j, to_torch(np.asarray(j), "cpu")

    for c in (rkv, kv):
        c.bm.allocate(0, 11)
        c.bm.allocate(1, 6)
    k0, v0 = same(rng.randn(3, 11, 2, 8)), same(rng.randn(3, 11, 2, 8))
    rkv.write_prefill(0, k0[0], v0[0], 11)
    kv.write_prefill(0, k0[1], v0[1], 11)
    k1, v1 = same(rng.randn(3, 2, 2, 8)), same(rng.randn(3, 2, 2, 8))
    rkv.write_prefill(1, k1[0], v1[0], 2, start=4)             # block-aligned suffix
    kv.write_prefill(1, k1[1], v1[1], 2, start=4)
    kn, vn = same(rng.randn(3, 2, 2, 8)), same(rng.randn(3, 2, 2, 8))
    rkv.append_tokens([0, 1], kn[0], vn[0], [11, 6])           # one fused append
    kv.append_tokens([0, 1], kn[1], vn[1], [11, 6])
    rkv.append_token(1, kn[0][:, 0], vn[0][:, 0], 7)           # reference path
    kv.append_token(1, kn[1][:, 0], vn[1][:, 0], 7)
    np.testing.assert_array_equal(_bits(kv.pool), _bits(rkv.pool))
    np.testing.assert_array_equal(kv.export_block_tables([0, 1]),
                                  rkv.export_block_tables([0, 1]))
    for a, b in zip(kv.gather_dense(0, 14), rkv.gather_dense(0, 14)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for a, b in zip(kv.gather_prefix(1, 4), rkv.gather_prefix(1, 4)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert kv.num_pool_dispatches == rkv.num_pool_dispatches
