"""The port's host-DRAM tier on the CPU, against the reference: the
demote -> promote round trip at the page level, and the tier end to end
through both packages' PDCluster on the qwen3-1.7b smoke config with the
reference's weights bridged (ports of the non-simulator cases of
``tests/test_tiered_kv.py``: ``:78``, ``:137``, ``:168``, ``:241``, ``:289``,
``:349``). Both clusters run under the reference's own profile and target
(``TPU_V5E`` with ``peak_flops=1e6``, ``target="tpu"``), so the shared
control plane takes the same decisions on both sides.

Bars: demote then promote is bit-identical, even after the vacated pool
blocks are overwritten; one dispatch each way per plan; tokens equal the
local-hit and the recompute paths' and the reference's; no leaks in either
tier; ``tier_demoted_blocks``, ``tier_promoted_blocks``,
``tier_host_resident`` and the demote/promote dispatch counts equal the
reference's. On the CPU the host pool is a plain CPU tensor and K1's
wrapper runs its plain version; the pinned route is held on the card
(``test_torch_tier_kernels.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as RF  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core import layout as RL  # noqa: E402
from repro.core.block_manager import BlockManager as RefBM  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving.cluster import PDCluster as RefCluster  # noqa: E402
from repro.serving.host_tier import TierManager as RefTM  # noqa: E402
from repro.serving.kv_cache import PagedKVCache as RefKV  # noqa: E402
from repro.serving.prefix_cache import GlobalPrefixIndex as RefIndex  # noqa: E402
from repro.serving.request import Request as RefRequest  # noqa: E402
from repro.serving.request import SamplingParams as RefSampling  # noqa: E402
from repro.sim.hardware import TPU_V5E as REF_V5E  # noqa: E402
from repro_torch import faults as F  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core import transfer as TR  # noqa: E402
from repro_torch.core.block_manager import BlockManager  # noqa: E402
from repro_torch.models.bridge import from_reference  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.host_tier import TierManager  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serving.prefix_cache import TIER_DRAM, TIER_HBM, GlobalPrefixIndex  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402
from repro_torch.sim.hardware import TPU_V5E  # noqa: E402

TIER_STATS = ("tier_demoted_blocks", "tier_promoted_blocks", "tier_host_resident",
              "finished", "prefix_hits", "prefix_tokens_reused", "prefill_tokens_computed",
              "prefix_fetches", "cached_reused", "cached_evicted")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_smoke("qwen3-1.7b")
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, rparams),
                            get_smoke_config("qwen3-1.7b"), device="cpu")
    return rparams, params


class Side:
    """One package's cluster, requests and fault specs, under the
    reference's profile and target."""

    def __init__(self, port: bool, weights):
        self.port = port
        self.cfg = get_smoke_config("qwen3-1.7b") if port else ref_smoke("qwen3-1.7b")
        self.params = weights[1] if port else weights[0]
        self.weak = dataclasses.replace(TPU_V5E if port else REF_V5E, peak_flops=1e6)
        self.faults = F if port else RF

    def cluster(self, **kw):
        kw = {"hardware": self.weak, "max_batch_tokens": 4096, **kw}
        if self.port:
            return PDCluster(self.cfg, self.params, device="cpu", target="tpu", **kw)
        return RefCluster(self.cfg, self.params, **kw)

    def request(self, prompt, steps):
        if self.port:
            return Request(prompt_tokens=list(prompt),
                           sampling=SamplingParams(max_new_tokens=steps))
        return RefRequest(prompt_tokens=list(prompt), sampling=RefSampling(max_new_tokens=steps))


def _sides(weights):
    return Side(True, weights), Side(False, weights)


def _drain(cluster, want, max_steps=400):
    for _ in range(max_steps):
        cluster.step()
        if len(cluster.finished) + len(cluster.cancelled) >= want:
            return
    raise AssertionError(f"stalled: {len(cluster.finished)}+{len(cluster.cancelled)}/{want}")


def _audit(cluster):
    assert cluster.audit_blocks() == 0
    cluster.assert_no_leaks()
    for tm in cluster.tiers.values():
        if tm.node_id not in cluster._dead:
            tm.check_invariants()


def _tier_counts(cluster):
    """The tier stats plus each node's demote/promote dispatch counts."""
    s = cluster.stats()
    out = {k: s[k] for k in TIER_STATS}
    out["dispatches"] = {nid: (tm.demote_dispatches, tm.promote_dispatches,
                               tm.host_evicted_blocks)
                         for nid, tm in cluster.tiers.items()}
    return out


def _same_tiers(port, ref):
    """Tier counters, dispatch counts and token streams equal across the
    packages; no leaks on either tier of the port."""
    assert _tier_counts(port) == _tier_counts(ref)
    assert [list(map(int, r.output_tokens)) for r in port.finished] == \
        [list(map(int, r.output_tokens)) for r in ref.finished]
    _audit(port)


def _toks(reqs):
    return [list(map(int, r.output_tokens)) for r in reqs]


# ---------------------------------------------------------------------------
# page-level bit identity: demote -> promote round trip
# ---------------------------------------------------------------------------
def test_demote_promote_roundtrip_bit_identical():
    """The pages that come back from the host tier are the exact pages that
    went down, after the vacated pool blocks are overwritten; one dispatch
    each way; the same tier state and counters as the reference's."""
    kw = dict(num_layers=2, num_blocks=8, block_size=4, num_kv_heads=2, head_dim=8)
    out = {}
    for port in (True, False):
        spec = (L.KVCacheSpec(**kw, dtype=torch.float32) if port
                else RL.KVCacheSpec(**kw, dtype=jnp.float32))
        kv = PagedKVCache(spec, device="cpu") if port else RefKV(spec)
        bm = (BlockManager if port else RefBM)(spec.num_blocks, spec.block_size)
        index = (GlobalPrefixIndex if port else RefIndex)(spec.block_size)
        bm.on_free = lambda blocks, index=index: index.invalidate_blocks(0, blocks)
        tm = (TierManager if port else RefTM)(0, bm, index, spec, host_blocks=8, kv=kv).attach()
        prompt = list(range(12))               # 3 full blocks
        blocks = bm.allocate(1, len(prompt))
        index.insert(0, prompt, blocks)
        fill = np.arange(int(np.prod(spec.shape)), dtype=np.float32).reshape(spec.shape)
        if port:
            kv.pool.copy_(torch.from_numpy(fill))
        else:
            kv.pool = jnp.asarray(fill)
        want = fill[blocks]
        before = TR.total_dispatches()

        bm.free(1)
        bm.reclaim_cache()                     # capacity pressure -> demote
        assert tm.demoted_blocks == 3 and tm.host.num_resident == 3
        assert index.lookup(0, prompt).tiers == [TIER_DRAM] * 3
        if port:                               # the host pool holds the pages, in place
            hb = list(index._node_host_blocks[0])
            np.testing.assert_array_equal(tm.host.pool[sorted(hb)].numpy(), want)
            kv.pool[torch.as_tensor(blocks)] = -1.0     # scribble over the vacated blocks
        else:
            kv.pool = kv.pool.at[jnp.asarray(blocks)].set(-1.0)

        assert tm.promote_match(prompt) == 3
        assert tm.host.num_resident == 0       # move semantics: the host side is freed
        m = index.lookup(0, prompt)
        assert m.tiers == [TIER_HBM] * 3
        got = (kv.pool[torch.as_tensor(m.block_ids)].numpy() if port
               else np.asarray(kv.pool[jnp.asarray(m.block_ids)]))
        np.testing.assert_array_equal(got, want)
        assert all(bm.is_cached(b) for b in m.block_ids)
        bm.check_invariants()
        tm.check_invariants()
        if port:                               # one K1 dispatch each way
            assert TR.total_dispatches() - before == 2
        out[port] = (tm.stats(), m.block_ids, sorted(bm.cached_blocks()))
    assert out[True] == out[False]
    assert out[True][0]["demote_dispatches"] == out[True][0]["promote_dispatches"] == 1


# ---------------------------------------------------------------------------
# end-to-end token identity on real compute
# ---------------------------------------------------------------------------
def _play(side, prompts, **kw):
    """One conversation: prompts submitted strictly one after another."""
    cluster = side.cluster(num_prefill=1, num_decode=0, num_blocks=16, **kw)
    reqs = []
    for p in prompts:
        reqs.append(side.request(p, 6))
        cluster.submit(reqs[-1])
        _drain(cluster, len(reqs))
    _audit(cluster)
    return cluster, reqs


def test_engine_roundtrip_token_identity(weights):
    """turn1 parks its prefix; churn demotes it; turn2 promotes it back —
    tokens equal a never-demoted run, a reuse-off run and the reference's."""
    pt, rf = _sides(weights)
    rng = np.random.RandomState(0)
    turn1 = rng.randint(0, pt.cfg.vocab_size, size=256).tolist()
    churn = rng.randint(0, pt.cfg.vocab_size, size=320).tolist()
    turn2 = turn1 + rng.randint(0, pt.cfg.vocab_size, size=48).tolist()
    convo = [turn1, churn, turn2]

    tiered, treqs = _play(pt, convo, host_tier_blocks=64)
    s = tiered.stats()
    assert s["tier_demoted_blocks"] > 0, "pool pressure never demoted"
    assert s["tier_promoted_blocks"] > 0, "turn 2 never promoted"
    assert treqs[2].num_cached_prefix_tokens >= 256
    assert all(tm.demote_dispatches and tm.promote_dispatches for tm in tiered.tiers.values())
    ref_tiered, _ = _play(rf, convo, host_tier_blocks=64)
    _same_tiers(tiered, ref_tiered)

    _, creqs = _play(pt, convo, prefix_reuse=False)
    _, nreqs = _play(pt, convo)                # reuse on, HBM-only
    assert _toks(treqs) == _toks(creqs) == _toks(nreqs)


# ---------------------------------------------------------------------------
# remote-DRAM fetch: source-side promote + fused pool->pool pull
# ---------------------------------------------------------------------------
def _remote(side, donor, follower, **kw):
    cluster = side.cluster(num_prefill=1, num_decode=1, num_blocks=64,
                           host_tier_blocks=kw.pop("host", 64), **kw)
    r0 = side.request(donor, 8)
    cluster.submit(r0)
    _drain(cluster, 1)
    # capacity pressure on the DECODE node, where the prefix re-homed
    cluster.engines[1].scheduler.bm.reclaim_cache()
    r1 = side.request(follower, 6)
    cluster.submit(r1)
    _drain(cluster, 2)
    _audit(cluster)
    return cluster, r1


def test_remote_dram_fetch_matches_local_hit_and_recompute(weights):
    pt, rf = _sides(weights)
    rng = np.random.RandomState(4)
    prefix = rng.randint(0, pt.cfg.vocab_size, size=128).tolist()
    donor = prefix + rng.randint(0, pt.cfg.vocab_size, size=8).tolist()
    follower = prefix + rng.randint(0, pt.cfg.vocab_size, size=40).tolist()

    cluster, r1 = _remote(pt, donor, follower)
    src_tm = cluster.tiers[1]
    assert src_tm.demoted_blocks >= 4 and src_tm.promoted_blocks >= 4
    assert src_tm.demote_dispatches == src_tm.promote_dispatches == 1
    assert r1.num_cached_prefix_tokens >= 128
    fetches = [t for t in cluster.transfers if t.kind == "prefix_fetch"]
    assert fetches and all(t.num_dispatches == 1 for t in fetches)
    ref_cluster, _ = _remote(rf, donor, follower)
    _same_tiers(cluster, ref_cluster)

    local = pt.cluster(num_prefill=1, num_decode=0, num_blocks=64)
    l0, l1 = pt.request(donor, 8), pt.request(follower, 6)
    local.submit(l0)
    _drain(local, 1)
    local.submit(l1)
    _drain(local, 2)
    assert l1.num_cached_prefix_tokens >= 128

    cold = pt.cluster(num_prefill=1, num_decode=1, num_blocks=64, prefix_reuse=False)
    c0, c1 = pt.request(donor, 8), pt.request(follower, 6)
    cold.submit(c0)
    _drain(cold, 1)
    cold.submit(c1)
    _drain(cold, 2)
    assert _toks([r1]) == _toks([l1]) == _toks([c1])


# ---------------------------------------------------------------------------
# fault paths: zero leaked blocks on either tier
# ---------------------------------------------------------------------------
def _cancel_while_demoting(side, prefix):
    cluster = side.cluster(num_prefill=1, num_decode=0, num_blocks=32, host_tier_blocks=64)
    cluster.submit(side.request(prefix, 6))
    _drain(cluster, 1)
    victim = side.request(prefix + [1, 2, 3], 6)
    cluster.submit(victim)                     # waiting, plan -> local blocks
    cluster.engines[0].scheduler.bm.reclaim_cache()   # demotes under it
    assert cluster.tiers[0].demoted_blocks >= 4
    assert cluster.cancel(victim)
    for _ in range(4):
        cluster.step()
    _audit(cluster)
    retry = side.request(prefix + [4, 5, 6], 6)       # the tier survived the cancel
    cluster.submit(retry)
    _drain(cluster, 2)
    assert cluster.tiers[0].promoted_blocks >= 4
    assert retry.num_cached_prefix_tokens >= 128
    late = side.request(prefix + [7, 8, 9], 32)        # cancel mid-decode afterwards
    cluster.submit(late)
    for _ in range(40):
        cluster.step()
        if any(late.request_id == r.request_id for e in cluster.engines.values()
               for r in e.scheduler.decode.running):
            break
    assert cluster.cancel(late)
    for _ in range(4):
        cluster.step()
    _audit(cluster)
    return cluster


def test_cancel_while_demoting_no_leak(weights):
    pt, rf = _sides(weights)
    prefix = np.random.RandomState(7).randint(0, pt.cfg.vocab_size, size=128).tolist()
    _same_tiers(_cancel_while_demoting(pt, prefix), _cancel_while_demoting(rf, prefix))


def _crash_play(side, donor, follower, faults=None, crash_probe=False):
    cluster = side.cluster(num_prefill=1, num_decode=1, num_blocks=64, host_tier_blocks=64,
                           faults=faults, heartbeat_timeout_cycles=2.0)
    cluster.submit(side.request(donor, 8))
    _drain(cluster, 1)
    cluster.engines[1].scheduler.bm.reclaim_cache()   # prefix -> DRAM
    r1 = side.request(follower, 6)
    cluster.submit(r1)
    if crash_probe:
        return cluster.clock                   # the fetch would run NEXT step
    _drain(cluster, 2, max_steps=600)
    return cluster, r1


def test_crash_during_promote_no_leak(weights):
    """The source dies between routing (plan on its DRAM prefix) and the
    promote + fetch: the plan degrades to recompute, tokens stay exact and
    neither tier leaks."""
    pt, rf = _sides(weights)
    rng = np.random.RandomState(9)
    prefix = rng.randint(0, pt.cfg.vocab_size, size=128).tolist()
    donor = prefix + rng.randint(0, pt.cfg.vocab_size, size=8).tolist()
    follower = prefix + rng.randint(0, pt.cfg.vocab_size, size=40).tolist()
    runs = {}
    for side in (pt, rf):
        t_crash = _crash_play(side, donor, follower, crash_probe=True) + 1.0
        runs[side.port] = _crash_play(
            side, donor, follower,
            faults=(side.faults.FaultSpec("node_crash", at=t_crash, node_id=1),))
    cluster, r1 = runs[True]
    assert 1 in cluster._dead, "the armed crash never fired"
    assert cluster.tiers[1].promoted_blocks == 0, "promotion ran on a dead node"
    assert cluster.tiers[1].host.num_resident == 0
    assert not cluster.controller.prefix_index._node_host_blocks.get(1)
    _same_tiers(cluster, runs[False][0])
    assert cluster.stats()["fault_kills"] == runs[False][0].stats()["fault_kills"] == 1

    cold = pt.cluster(num_prefill=1, num_decode=0, num_blocks=64, prefix_reuse=False)
    c1 = pt.request(follower, 6)
    cold.submit(c1)
    _drain(cold, 1)
    assert _toks([r1]) == _toks([c1])


# ---------------------------------------------------------------------------
# regression: refcount-zero prefixes stay cached until pressure
# ---------------------------------------------------------------------------
def _rehit(side, prefix, tail):
    cluster = side.cluster(num_prefill=1, num_decode=0, num_blocks=64)
    cluster.submit(side.request(prefix, 4))
    _drain(cluster, 1)
    bm = cluster.engines[0].scheduler.bm
    assert not bm._table, "donor's table survived its finish"
    assert bm.num_cached >= 3, "finished donor's blocks were not parked"
    late = side.request(prefix + tail, 4)
    cluster.submit(late)
    _drain(cluster, 2)
    assert late.num_cached_prefix_tokens >= 96
    assert bm.cached_reused >= 3
    assert cluster.stats()["prefix_tokens_reused"] >= 96
    _audit(cluster)
    return cluster


def test_refcount_zero_prefix_rehits_after_free(weights):
    pt, rf = _sides(weights)
    rng = np.random.RandomState(13)
    prefix = rng.randint(0, pt.cfg.vocab_size, size=96).tolist()
    tail = rng.randint(0, pt.cfg.vocab_size, size=16).tolist()
    _same_tiers(_rehit(pt, prefix, tail), _rehit(rf, prefix, tail))
