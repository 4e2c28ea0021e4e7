"""Sharded disaggregated serving in the port against the reference, on the
CPU: a port of ``tests/test_sharded_serving.py``, case for case, with the
reference's weights bridged (``from_reference``) and the same prompts.

Bars:

* a TP=2 cluster (single-device emulation: per-shard params, concatenation
  before every combine contraction) gives greedy tokens identical to the
  reference's monolithic generation and to the port's unsharded (TP=1)
  ``greedy_generate``, dense (qwen3 smoke) and MoE (granite-moe smoke);
* a cross-degree transfer (2->1, 1->2, 2->4, 4->2, 2->2) lands pools bit
  for bit equal to the reference's ``ShardedTransferEngine`` on the same
  pools and to the unsharded transfer, in ``sharded_transfer_calls``
  launches, and ``verify_sharded_transfer`` gives the reference's verdicts;
* the fault plane (corruption caught by the per-pair verify and repaired by
  the retry, a node kill with a shard-aware leak audit) works through
  sharded pools, with the reference's counters;
* ``shard_params`` slices each leaf on the dim the reference slices, to the
  same values.

The reference's generations are computed once per module.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as RF  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core import layout as RL  # noqa: E402
from repro.core import transfer as RTR  # noqa: E402
from repro.distributed import tp as RTP  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving.cluster import PDCluster as RefCluster  # noqa: E402
from repro.serving.request import Request as RefRequest  # noqa: E402
from repro.serving.request import SamplingParams as RefSampling  # noqa: E402
from repro_torch import faults as F  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.costmodel import sharded_transfer_calls  # noqa: E402
from repro_torch.core.layout import KVCacheSpec  # noqa: E402
from repro_torch.core.transfer import (ShardedTransferEngine, ShardSpec,  # noqa: E402
                                       TransferEngine, shard_pairs,
                                       verify_sharded_transfer)
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.bridge import from_reference  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _models(arch, seed):
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(seed))
    params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return rcfg, rparams, cfg, params


@pytest.fixture(scope="module")
def dense_model():
    return _models("qwen3-1.7b", 0)


@pytest.fixture(scope="module")
def moe_model():
    return _models("granite-moe-1b-a400m", 1)


def _prompts(cfg, n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, cfg.vocab_size, size=rng.randint(6, 24)))
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_tokens(arch, seed, prompt_seed, n, steps):
    """The reference's monolithic greedy generation, once per module."""
    rcfg, rparams, cfg, _ = _models(arch, seed)
    return {tuple(p): [int(x) for x in RT.greedy_generate(
        rparams, rcfg, jnp.asarray([p], jnp.int32), steps)[0]]
        for p in _prompts(cfg, n, prompt_seed)}


def _port_tokens(cfg, params, prompts, steps):
    return {tuple(p): [int(x) for x in T.greedy_generate(
        params, cfg, torch.tensor([p], dtype=torch.int32), steps)[0]] for p in prompts}


def _run_cluster(cfg, params, prompts, steps, **kw):
    cluster = PDCluster(cfg, params, num_prefill=1, num_decode=1,
                        num_blocks=128, device="cpu", **kw)
    reqs = [Request(prompt_tokens=list(p),
                    sampling=SamplingParams(max_new_tokens=steps))
            for p in prompts]
    done = cluster.run(reqs, max_cycles=120)
    assert len(done) == len(prompts)
    return cluster, done


# ---------------------------------------------------------------------------
# token identity: sharded engines vs the reference and the unsharded port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model_fixture", ["dense_model", "moe_model"])
def test_tp2_cluster_token_identity(model_fixture, request):
    """TP=2 prefill AND decode: every output token equal to the reference's
    monolithic generation and to the port's TP=1 generation."""
    rcfg, _, cfg, params = request.getfixturevalue(model_fixture)
    seed = 0 if model_fixture == "dense_model" else 1
    prompts = _prompts(cfg)
    refs = _reference_tokens(cfg.name.replace("-smoke", ""), seed, 0, 3, 5)
    assert _port_tokens(cfg, params, prompts, 5) == refs
    cluster, done = _run_cluster(cfg, params, prompts, 5, tp_degrees={0: 2, 1: 2})
    for r in done:
        assert r.output_tokens == refs[tuple(r.prompt_tokens)]
    stats = cluster.stats()
    assert stats["sharded_nodes"] == 2
    assert stats["max_tp_degree"] == 2
    assert stats["mean_transfer_dispatches"] == sharded_transfer_calls(2, 2)
    assert stats["shard_dispatches"] > 0
    assert stats["leaked_blocks"] == 0.0


def test_moe_tp2_reports_ep_degree(moe_model):
    _, _, cfg, params = moe_model
    cluster = PDCluster(cfg, params, num_prefill=1, num_decode=1,
                        num_blocks=64, tp_degrees={0: 2}, device="cpu")
    assert cluster.engines[0].tp_degree == 2
    assert cluster.engines[0].ep_degree == 2   # experts shard with the mesh
    assert cluster.engines[1].tp_degree == 1
    assert cluster.engines[1].ep_degree == 1
    assert RTP.ep_degree(ref_smoke("granite-moe-1b-a400m"), 2) == TP.ep_degree(cfg, 2)


@pytest.mark.parametrize("tp_degrees,expected_dispatches", [
    ({0: 2, 1: 1}, 2),   # TP=2 prefill -> TP=1 decode
    ({0: 1, 1: 2}, 2),   # TP=1 prefill -> TP=2 decode
])
def test_cross_degree_cluster_token_identity(dense_model, tp_degrees,
                                             expected_dispatches):
    """Cross-degree disaggregation: resharding happens inside the transfer
    (one K1 launch per shard pair), tokens equal the reference's."""
    _, _, cfg, params = dense_model
    prompts = _prompts(cfg, seed=2)
    refs = _reference_tokens("qwen3-1.7b", 0, 2, 3, 5)
    cluster, done = _run_cluster(cfg, params, prompts, 5, tp_degrees=tp_degrees)
    for r in done:
        assert r.output_tokens == refs[tuple(r.prompt_tokens)]
    stats = cluster.stats()
    assert stats["mean_transfer_dispatches"] == expected_dispatches
    assert expected_dispatches == sharded_transfer_calls(
        tp_degrees.get(0, 1), tp_degrees.get(1, 1))
    assert stats["leaked_blocks"] == 0.0


def test_request_handle_surfaces_sharding(dense_model):
    from repro_torch.serving.api import FlowKVClient
    _, _, cfg, params = dense_model
    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1,
                          num_blocks=64, tp_degrees={0: 2, 1: 1}, device="cpu")
    handle = client.submit(_prompts(cfg, n=1, seed=4)[0],
                           SamplingParams(max_new_tokens=3))
    handle.result()
    stats = handle.stats()
    assert stats["prefill_tp_degree"] == 2
    assert stats["decode_tp_degree"] == 1
    assert stats["prefill_ep_degree"] == 1
    assert stats["shard_dispatches"] == sharded_transfer_calls(2, 1)


# ---------------------------------------------------------------------------
# shard_params: the reference's rule walk, views of the full tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,tp", [("qwen3-1.7b", 2), ("granite-moe-1b-a400m", 2),
                                     ("granite-moe-1b-a400m", 4)])
def test_shard_params_match_reference(arch, tp):
    rcfg, rparams, cfg, params = _models(arch, 0)
    if tp == 4:      # the smoke config has 2 kv-heads: widen it for tp 4
        import dataclasses
        rcfg = dataclasses.replace(rcfg, num_kv_heads=4)
        cfg = dataclasses.replace(cfg, num_kv_heads=4)
        rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(3))
        params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rshards = RTP.shard_params(rparams, rcfg, tp)
    shards = TP.shard_params(params, cfg, tp)
    assert len(shards) == len(rshards) == tp
    full = jax.tree.leaves(params)
    for rs, s in zip(rshards, shards):
        rl, pl = jax.tree.leaves(rs), jax.tree.leaves(s)
        assert len(rl) == len(pl) == len(full)
        for a, t, f in zip(rl, pl, full):
            assert tuple(t.shape) == a.shape
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
            # a view of the full tensor: no copy
            assert t.untyped_storage().data_ptr() == f.untyped_storage().data_ptr()
    merged = TP.merged_combine(shards, cfg)
    assert torch.equal(merged["wo"], params["layers"]["wo"])


# ---------------------------------------------------------------------------
# cross-degree transfer bit-exactness (pure transfer plane, synthetic pools)
# ---------------------------------------------------------------------------
_SPEC = KVCacheSpec(num_layers=2, num_blocks=12, block_size=4,
                    num_kv_heads=8, head_dim=4, dtype=torch.float32)
_RSPEC = RL.KVCacheSpec(num_layers=2, num_blocks=12, block_size=4,
                        num_kv_heads=8, head_dim=4, dtype=jnp.float32)


def _full_pool(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(*_SPEC.shape).astype(np.float32)


def _shard_pool(pool, tp):
    """Slice a full-width FLOWKV pool into per-shard kv-head slices."""
    nb, L = _SPEC.num_blocks, _SPEC.num_layers
    bs, kv, hd = _SPEC.block_size, _SPEC.num_kv_heads, _SPEC.head_dim
    kw = kv // tp
    six = np.asarray(pool).reshape(nb, L, 2, bs, kv, hd)
    return [np.ascontiguousarray(six[..., s * kw:(s + 1) * kw, :].reshape(nb, L, 2, -1))
            for s in range(tp)]


def _unshard_pool(pools, tp):
    nb, L = _SPEC.num_blocks, _SPEC.num_layers
    bs, kv, hd = _SPEC.block_size, _SPEC.num_kv_heads, _SPEC.head_dim
    six = [np.asarray(p).reshape(nb, L, 2, bs, kv // tp, hd) for p in pools]
    return np.concatenate(six, axis=4).reshape(_SPEC.shape)


def _t(pools):
    return [torch.from_numpy(p.copy()) for p in pools]


@pytest.mark.parametrize("tp_src,tp_dst", [(2, 1), (1, 2), (2, 4), (4, 2), (2, 2)])
def test_cross_degree_transfer_bit_exact(tp_src, tp_dst):
    """A sharded transfer between pools of any degree pair lands the bytes
    of the reference's sharded engine and of the unsharded transfer, in one
    launch per overlapping shard pair."""
    src_full, dst_full = _full_pool(seed=10), _full_pool(seed=11)
    src_blocks, dst_blocks = [1, 2, 3, 7], [0, 4, 5, 9]

    ref_plain = TransferEngine(_SPEC)
    ref_plan = ref_plain.planner.plan("flowkv", src_blocks, dst_blocks)
    plain_dst = ref_plain.execute(ref_plan, torch.from_numpy(src_full),
                                  torch.from_numpy(dst_full.copy()))

    engine = ShardedTransferEngine(_SPEC, _SPEC, ShardSpec(tp_src, 8), ShardSpec(tp_dst, 8))
    plan = engine.plan("flowkv", src_blocks, dst_blocks)
    dst_pools = _t(_shard_pool(dst_full, tp_dst))
    out = engine.execute(plan, _t(_shard_pool(src_full, tp_src)), dst_pools)
    assert all(o is d for o, d in zip(out, dst_pools))          # in place

    rengine = RTR.ShardedTransferEngine(_RSPEC, _RSPEC, RTR.ShardSpec(tp_src, 8),
                                        RTR.ShardSpec(tp_dst, 8))
    rplan = rengine.plan("flowkv", src_blocks, dst_blocks)
    rdst = rengine.execute(rplan, [jnp.asarray(p) for p in _shard_pool(src_full, tp_src)],
                           [jnp.asarray(p) for p in _shard_pool(dst_full, tp_dst)])

    expected = sharded_transfer_calls(tp_src, tp_dst)
    assert engine.num_dispatches == rengine.num_dispatches == expected
    assert plan.num_dispatches == expected
    assert len(shard_pairs(engine.src_shard, engine.dst_shard)) == expected
    for p, r in zip(dst_pools, rdst):
        np.testing.assert_array_equal(p.numpy().view(np.int32), np.asarray(r).view(np.int32))
    np.testing.assert_array_equal(_unshard_pool([p.numpy() for p in dst_pools], tp_dst),
                                  plain_dst.numpy())
    assert plan.total_bytes == ref_plan.total_bytes
    assert verify_sharded_transfer(plan, _SPEC, _t(_shard_pool(src_full, tp_src)),
                                   _SPEC, dst_pools)


@pytest.mark.parametrize("local_heads,lo,hi", [(4, 0, 4), (4, 2, 4), (2, 1, 2), (8, 3, 5)])
def test_fine_page_rows_match_reference(local_heads, lo, hi):
    """The fine rows of a pair: the port's numpy rows and the rows the
    engine builds on the pool's device equal the reference's."""
    from repro_torch.core.transfer import _fine_rows_on, fine_page_rows
    pages = np.array([0, 5, 6, 7, 40, 3], np.int32)
    want = RTR.fine_page_rows(pages, 4, local_heads, lo, hi)
    np.testing.assert_array_equal(fine_page_rows(pages, 4, local_heads, lo, hi), want)
    got = _fine_rows_on(torch.device("cpu"), pages, 4, local_heads, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_per_pair_single_dispatch_accumulates():
    """num_dispatches grows by exactly the pair count per executed plan."""
    engine = ShardedTransferEngine(_SPEC, _SPEC, ShardSpec(4, 8), ShardSpec(2, 8))
    src_pools = _t(_shard_pool(_full_pool(3), 4))
    dst_pools = _t(_shard_pool(_full_pool(4), 2))
    per_plan = sharded_transfer_calls(4, 2)
    for i in range(3):
        plan = engine.plan("flowkv", [i, i + 4], [i + 1, i + 5])
        engine.execute(plan, src_pools, dst_pools)
        assert engine.num_dispatches == (i + 1) * per_plan


def test_verify_sharded_transfer_catches_corruption():
    """The port's per-pair integer compare and the reference's per-pair
    blake2b give the same verdicts, before and after one flipped element."""
    src_full = _full_pool(seed=20)
    engine = ShardedTransferEngine(_SPEC, _SPEC, ShardSpec(2, 8), ShardSpec(1, 8))
    plan = engine.plan("flowkv", [0, 1], [2, 3])
    src_pools = _t(_shard_pool(src_full, 2))
    dst_pools = engine.execute(plan, src_pools, [torch.from_numpy(_full_pool(seed=21))])
    rplan = RTR.ShardedTransferEngine(_RSPEC, _RSPEC, RTR.ShardSpec(2, 8),
                                      RTR.ShardSpec(1, 8)).plan("flowkv", [0, 1], [2, 3])

    def verdicts(dst):
        port = verify_sharded_transfer(plan, _SPEC, src_pools, _SPEC, dst)
        ref = RTR.verify_sharded_transfer(rplan, _RSPEC, [p.numpy() for p in src_pools],
                                          _RSPEC, [d.numpy() for d in dst])
        return port, ref

    assert verdicts(dst_pools) == (True, True)
    # flip one element inside a page the plan wrote -> the per-pair compare fails
    pid = int(plan.to_descriptors().page_ids(_SPEC, "dst")[0])
    dst_pools[0].view(-1, _SPEC.payload)[pid, 0] += 1.0
    assert verdicts(dst_pools) == (False, False)


# ---------------------------------------------------------------------------
# fault plane through sharded pools
# ---------------------------------------------------------------------------
def test_sharded_transfer_corruption_repaired_by_retry(dense_model):
    """Injected corruption on a sharded hop: the per-pair verify catches it,
    the retry re-executes, tokens stay exact; the counters are the
    reference cluster's on the same faults."""
    rcfg, rparams, cfg, params = dense_model
    prompts = _prompts(cfg, n=2, seed=6)
    refs = _reference_tokens("qwen3-1.7b", 0, 6, 2, 4)
    cluster, done = _run_cluster(
        cfg, params, prompts, 4, tp_degrees={0: 2, 1: 1},
        faults=[F.FaultSpec("transfer_corrupt", at=0.0, count=2)])
    for r in done:
        assert r.output_tokens == refs[tuple(r.prompt_tokens)]
    stats = cluster.stats()
    assert stats["transfer_retries"] >= 1
    assert stats["degraded_to_recompute"] == 0
    assert stats["leaked_blocks"] == 0.0
    ref = RefCluster(rcfg, rparams, num_prefill=1, num_decode=1, num_blocks=128,
                     tp_degrees={0: 2, 1: 1},
                     faults=[RF.FaultSpec("transfer_corrupt", at=0.0, count=2)])
    ref.run([RefRequest(prompt_tokens=list(p), sampling=RefSampling(max_new_tokens=4))
             for p in prompts], max_cycles=120)
    rstats = ref.stats()
    for key in ("transfer_retries", "degraded_to_recompute", "mean_transfer_dispatches",
                "shard_dispatches", "finished"):
        assert stats[key] == rstats[key], key


def test_shard_aware_leak_audit_under_node_kill(dense_model):
    """Kill the TP=1 decode node while requests are in flight: recovery
    re-prefills on the surviving TP=2 node, every request terminates with
    the reference's tokens, and the fleet-wide block audit (including the
    sharded pool's shared block manager) reports zero leaks."""
    _, _, cfg, params = dense_model
    prompts = _prompts(cfg, n=3, seed=8)
    refs = _reference_tokens("qwen3-1.7b", 0, 8, 3, 4)
    cluster = PDCluster(cfg, params, num_prefill=1, num_decode=1,
                        num_blocks=128, tp_degrees={0: 2, 1: 1},
                        heartbeat_timeout_cycles=2.0, device="cpu")
    reqs = [Request(prompt_tokens=list(p), sampling=SamplingParams(max_new_tokens=4))
            for p in prompts]
    for r in reqs:
        cluster.submit(r)
    for _ in range(2):           # get KV in flight before the kill
        cluster.step()
    cluster.kill_node(1)         # the decode side dies mid-run
    cluster.run([], max_cycles=120)
    assert len(cluster.finished) == len(prompts)
    for r in cluster.finished:
        # recovery replays emitted tokens teacher-forced (appended to
        # prompt_tokens): match each request to its ORIGINAL prompt by prefix
        p = next(pp for pp in prompts if list(r.prompt_tokens[:len(pp)]) == list(pp))
        assert [int(t) for t in r.output_tokens] == refs[tuple(p)]
    assert cluster.audit_blocks() == 0
    cluster.assert_no_leaks()
    for shard in cluster.engines[0].kv.shards:
        assert shard.bm is cluster.engines[0].kv.bm
    cluster.engines[0].kv.check_invariants()
