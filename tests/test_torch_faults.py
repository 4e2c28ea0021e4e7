"""The port's fault plane on the CPU, against the reference: deterministic
fault injection, the mid-prefill and mid-decode kills, corruption caught by
the transfer verify and repaired by the retry, retry exhaustion degrading to
recompute, a destination killed between layer-window sub-plans, cancel while
parked in the retry queue, leak audits with both allocators and the
heartbeat staleness knob — each run by BOTH packages' PDCluster on the
qwen3-1.7b smoke config with the reference's weights bridged and the same
seeded ``FaultSpec``s (ports of ``tests/test_fault_tolerance.py:92-300``).

Bars: recovery is token-exact against the port's monolithic
``greedy_generate`` and the reference cluster's tokens; each token is
streamed exactly once; no block leaks; ``fault_kills``,
``transfer_retries``, ``degraded_to_recompute`` and ``recoveries`` equal the
reference's. ``verify_transfer`` (the port compares the plan's pages as
integers on the pool's device) gives the reference's blake2b verdict on the
same pools, NaN payloads and signed zeros included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as RF  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core import layout as RL  # noqa: E402
from repro.core import transfer as RTR  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.obs.tracing import attach_tracer as ref_attach_tracer  # noqa: E402
from repro.serving.api import FlowKVClient as RefClient  # noqa: E402
from repro.serving.cluster import PDCluster as RefCluster  # noqa: E402
from repro.serving.request import RequestState as RefState  # noqa: E402
from repro.serving.request import SamplingParams as RefSampling  # noqa: E402
from repro_torch import faults as F  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core import transfer as TR  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.bridge import from_reference, to_torch  # noqa: E402
from repro_torch.obs.tracing import attach_tracer  # noqa: E402
from repro_torch.serving.api import FlowKVClient  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.request import RequestState, SamplingParams  # noqa: E402

COUNTERS = ("fault_kills", "transfer_retries", "degraded_to_recompute", "recoveries",
            "finished")


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
    """One package's cluster, client, fault specs and request states."""

    def __init__(self, port: bool, weights):
        self.port = port
        self.cfg = get_smoke_config("qwen3-1.7b") if port else ref_smoke("qwen3-1.7b")
        self.params = weights[1] if port else weights[0]
        self.faults = F if port else RF
        self.state = RequestState if port else RefState
        self.sampling = SamplingParams if port else RefSampling
        self.client_cls = FlowKVClient if port else RefClient

    def cluster(self, **kw):
        if self.port:
            return PDCluster(self.cfg, self.params, device="cpu", **kw)
        return RefCluster(self.cfg, self.params, **kw)

    def specs(self, *specs):
        """Port-neutral (kind, kwargs) specs as this package's FaultSpecs."""
        return [self.faults.FaultSpec(kind, **kw) for kind, kw in specs]

    def tracer(self, cluster):
        return attach_tracer(cluster) if self.port else ref_attach_tracer(cluster)


def _sides(weights):
    return Side(True, weights), Side(False, weights)


def _prompts(vocab, n=3, seed=5):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=rng.randint(5, 30)))) for _ in range(n)]


@pytest.fixture(scope="module")
def chaos_case(weights):
    """ONE prompt set + the port's greedy reference, shared by every case."""
    pt = Side(True, weights)
    prompts = _prompts(pt.cfg.vocab_size)
    refs = {tuple(p): T.greedy_generate(pt.params, pt.cfg, torch.tensor([p], dtype=torch.int32),
                                        8)[0].tolist() for p in prompts}
    return prompts, refs


def _run_chaos(side, prompts, faults, *, num_prefill=1, num_decode=2, steps=8,
               max_cycles=400, **kw):
    """Submit ``prompts``, drive every stream round-robin to completion, and
    return (cluster, handles, streams)."""
    cluster = side.cluster(num_prefill=num_prefill, num_decode=num_decode, num_blocks=128,
                           faults=side.specs(*faults), heartbeat_timeout_cycles=2.0, **kw)
    client = side.client_cls.from_cluster(cluster)
    handles = [client.submit(list(p), side.sampling(max_new_tokens=steps)) for p in prompts]
    streams = {h.request_id: [] for h in handles}
    gens = {h.request_id: h.tokens(max_cycles=max_cycles) for h in handles}
    done = set()
    while len(done) < len(handles):
        for h in handles:
            if h.request_id in done:
                continue
            try:
                streams[h.request_id].append(int(next(gens[h.request_id])))
            except StopIteration:
                done.add(h.request_id)
    return cluster, handles, streams


def _assert_token_exact(side, handles, refs, streams=None):
    for h in handles:
        req = h.request
        key = tuple(req.prompt_tokens[:req.client_prompt_len]
                    if req.client_prompt_len else req.prompt_tokens)
        assert req.state is side.state.FINISHED
        assert [int(t) for t in req.output_tokens] == refs[key], (
            f"request {req.request_id} diverged after recovery")
        if streams is not None:
            assert streams[h.request_id] == [int(t) for t in req.output_tokens], (
                f"request {req.request_id} stream violated exactly-once")


def _both(weights, refs, run, streamed=True):
    """Run one case on both packages: token-exact (and exactly-once) on each,
    the same counters on each, no leaks. Returns the two (cluster, handles)."""
    out = []
    for side in _sides(weights):
        cluster, handles, streams = run(side)
        _assert_token_exact(side, handles, refs, streams if streamed else None)
        cluster.assert_no_leaks()
        assert cluster.audit_blocks() == 0
        out.append((cluster, handles))
    (pc, ph), (rc, rh) = out
    ps, rs = pc.stats(), rc.stats()
    assert {k: ps[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    assert [[int(t) for t in h.request.output_tokens] for h in ph] == \
        [[int(t) for t in h.request.output_tokens] for h in rh]
    return out


# -- fault injector ----------------------------------------------------------------
def test_injector_is_deterministic_and_replayable():
    def make(pkg):
        return pkg.FaultInjector([pkg.FaultSpec("node_crash", at=3.0, node_id=1),
                                  pkg.FaultSpec("transfer_fail", at=0.0, rate=0.3),
                                  pkg.FaultSpec("degraded_bandwidth", at=5.0,
                                                duration=2.0, factor=4.0)], seed=7)

    inj, ref = make(F), make(RF)
    run1 = [inj.transfer_attempt(float(t)) for t in range(20)]
    assert run1 == [ref.transfer_attempt(float(t)) for t in range(20)]
    inj.reset()
    assert [inj.transfer_attempt(float(t)) for t in range(20)] == run1   # replays
    assert any(f == "fail" for f in run1)
    inj.reset()
    assert [s.node_id for s in inj.due(3.5)] == [1]
    assert inj.due(3.5) == []                 # one-shot: fires once
    assert inj.bandwidth_factor(6.0) == 4.0
    assert inj.bandwidth_factor(8.0) == 1.0   # window closed
    assert inj.to_meta() == ref.to_meta()
    clone = F.as_injector(inj.to_meta())      # meta round-trip (replay path)
    clone.reset()
    assert [clone.transfer_attempt(float(t)) for t in range(20)] == run1


# -- crash recovery -------------------------------------------------------------------
def test_mid_prefill_kill_token_identity(weights, chaos_case):
    prompts, refs = chaos_case
    (pc, _), _ = _both(weights, refs, lambda side: _run_chaos(
        side, prompts, [("node_crash", dict(at=1.0, node_id=0))], num_prefill=2, num_decode=1))
    assert pc.stats()["fault_kills"] == 1


def test_mid_decode_kill_exactly_once(weights, chaos_case):
    prompts, refs = chaos_case
    (pc, ph), _ = _both(weights, refs, lambda side: _run_chaos(
        side, prompts, [("node_crash", dict(at=4.0, node_id=1))]))
    assert pc.stats()["recoveries"] >= 1, "the crash landed after all decodes"
    recovered = [h for h in ph if h.stats()["recovered"]]
    assert recovered
    for h in recovered:
        assert h.stats()["replayed_tokens"] >= 1
        assert h.stats()["recovery_s"] > 0.0


def test_corruption_caught_retried_and_repaired(weights, chaos_case):
    """The injected corruption is caught by the transfer verify, retried
    once, and the clean re-import repairs the pages."""
    all_prompts, refs = chaos_case
    recs = {}

    def run(side):
        cluster = side.cluster(num_prefill=1, num_decode=1, num_blocks=128,
                               faults=side.specs(("transfer_corrupt", dict(at=0.0, count=1))))
        recs[side.port] = side.tracer(cluster)
        client = side.client_cls.from_cluster(cluster)
        handles = [client.submit(list(p), side.sampling(max_new_tokens=8))
                   for p in all_prompts[:2]]
        for h in handles:
            h.result(max_cycles=300)
        return cluster, handles, None

    (pc, ph), _ = _both(weights, refs, run, streamed=False)
    assert pc.stats()["transfer_retries"] == 1
    assert sum(h.stats()["transfer_retries"] for h in ph) == 1
    for port, rec in recs.items():
        retry_spans = rec.by_name("transfer_retry")
        assert len(retry_spans) == 1, port
        assert retry_spans[0].attrs["fault"] == "corrupt"
        assert retry_spans[0].attrs["backoff_s"] > 0.0
        assert not rec.by_name("failure")     # retry succeeded: no failover


def test_retry_exhaustion_degrades_to_recompute(weights, chaos_case):
    all_prompts, refs = chaos_case
    (pc, ph), _ = _both(weights, refs, lambda side: _run_chaos(
        side, all_prompts[:1], [("transfer_fail", dict(at=0.0, count=4))],
        num_prefill=1, num_decode=1), streamed=False)
    s = pc.stats()
    assert s["degraded_to_recompute"] == 1
    assert s["transfer_retries"] == 4
    assert ph[0].stats()["recovered"]


def test_kill_dst_mid_windowed_transfer_no_leak(weights, chaos_case):
    """The decode node dying BETWEEN layer-window sub-plans leaks none of the
    partially-imported dst blocks; the transfer restarts on a live node."""
    all_prompts, refs = chaos_case
    killed = {}

    def run(side):
        cluster = side.cluster(num_prefill=1, num_decode=2, num_blocks=128, layer_window=1,
                               heartbeat_timeout_cycles=2.0)
        client = side.client_cls.from_cluster(cluster)
        state = {"killed": None}
        for nid, eng in cluster.engines.items():
            if nid == 0:
                continue
            orig = eng.kv.import_plan

            def wrapper(engine_t, plan, src_pool, _orig=orig, _nid=nid):
                out = _orig(engine_t, plan, src_pool)
                if state["killed"] is None:   # die after the FIRST window
                    state["killed"] = _nid
                    cluster.kill_node(_nid)
                return out

            eng.kv.import_plan = wrapper
        h = client.submit(all_prompts[0], side.sampling(max_new_tokens=8))
        h.result(max_cycles=400)
        assert state["killed"] is not None, "layer-window path never ran"
        assert h.request.decode_node != state["killed"]
        assert [t for t in cluster.transfers if t.status == "aborted_dst_dead"]
        killed[side.port] = state["killed"]
        return cluster, [h], None

    (pc, _), (rc, _) = _both(weights, refs, run, streamed=False)
    assert killed[True] == killed[False]
    assert [(t.status, t.num_dispatches) for t in pc.transfers] == \
        [(t.status, t.num_dispatches) for t in rc.transfers]
    assert pc.stats()["leaked_blocks"] == 0


def test_cancel_while_failed_in_retry_queue(weights, chaos_case):
    """Cancelling a request parked controller-side (FAILED, unroutable) beats
    the reroute: terminal CANCELLED, empty retry queue, no block held."""
    prompts, _ = chaos_case
    for side in _sides(weights):
        cluster = side.cluster(num_prefill=1, num_decode=1, num_blocks=128,
                               heartbeat_timeout_cycles=2.0)
        client = side.client_cls.from_cluster(cluster)
        h = client.submit(prompts[0], side.sampling(max_new_tokens=32))
        for _ in range(4):                    # reach decode
            cluster.step()
        cluster.kill_node(0)
        cluster.kill_node(1)                  # whole fleet gone: unroutable
        for _ in range(6):                    # past the staleness window
            cluster.step()
        assert h.request.state is side.state.FAILED
        assert h.request in cluster.controller.retry_queue
        assert h.cancel()
        assert h.request.state is side.state.CANCELLED
        assert h.request not in cluster.controller.retry_queue
        assert cluster.audit_blocks() == 0
        assert list(h.tokens()) == h.request.output_tokens   # stream terminates
        cluster.assert_no_leaks()
        assert cluster.stats()["fault_kills"] == 2


@pytest.mark.parametrize("allocator", ["flowkv", "freelist"])
def test_no_leaks_after_chaos_both_allocators(weights, chaos_case, allocator):
    prompts, refs = chaos_case
    (pc, _), _ = _both(weights, refs, lambda side: _run_chaos(
        side, prompts, [("node_crash", dict(at=4.0, node_id=1)),
                        ("transfer_corrupt", dict(at=0.0, count=1))], allocator=allocator),
        streamed=False)
    for nid, eng in pc.engines.items():
        if nid in pc._dead:
            continue
        bm = eng.scheduler.bm
        assert bm.free_capacity == bm.num_blocks   # returned or cached


def test_heartbeat_staleness_knob(weights):
    """Liveness is pure staleness against ``heartbeat_timeout_cycles``."""
    pt = Side(True, weights)
    cluster = pt.cluster(num_prefill=1, num_decode=1, num_blocks=64,
                         heartbeat_timeout_cycles=3.0)
    cluster.step()
    cluster.step()
    cluster.kill_node(1)
    node = cluster.controller.nodes[1]
    assert node.last_heartbeat == 2.0         # real stamp, not a sentinel
    cluster.step()                            # staleness 1.0 < 3.0
    assert node.alive
    cluster.step()                            # 2.0
    cluster.step()                            # 3.0 — not strictly over yet
    assert node.alive
    cluster.step()                            # 4.0 > 3.0: dead
    assert not node.alive


# -- the transfer verify ------------------------------------------------------------------
_BITS = {"float32": (np.uint32, 0x7FC00001), "bfloat16": (np.uint16, 0x7FC1)}


def _verify_case(dtype, case):
    """Pools after one clean transfer, then one change; returns (src, dst)
    as numpy arrays in ``dtype`` and the two specs and plans."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    kw = dict(num_layers=3, num_blocks=16, block_size=4, num_kv_heads=2, head_dim=8)
    rspec, spec = RL.KVCacheSpec(**kw, dtype=jdt), L.KVCacheSpec(**kw, dtype=tdt)
    rengine, engine = RTR.TransferEngine(rspec), TR.TransferEngine(spec)
    rplan = rengine.planner.plan("flowkv", [0, 1, 2], [5, 6, 9])
    plan = engine.planner.plan("flowkv", [0, 1, 2], [5, 6, 9])
    src = np.asarray(jnp.asarray(np.random.RandomState(3).randn(*rspec.shape), jdt))
    dst = np.asarray(rengine.execute(rplan, jnp.asarray(src), jnp.zeros(rspec.shape, jdt)))
    # the port's own transfer lands the same bytes
    tdst = torch.zeros(spec.shape, dtype=tdt)
    engine.execute(plan, to_torch(src, "cpu"), tdst)
    np.testing.assert_array_equal(tdst.view(torch.int16 if dtype == "bfloat16"
                                            else torch.int32).numpy(),
                                  dst.view(np.int16 if dtype == "bfloat16" else np.int32))
    src, dst = src.copy(), dst.copy()
    uint, nan = _BITS[dtype]
    s_bits = src.reshape(-1, spec.payload).view(uint)
    d_bits = dst.reshape(-1, spec.payload).view(uint)
    page = int(plan.to_descriptors().page_ids(spec, "dst")[3])
    src_page = int(plan.to_descriptors().page_ids(spec, "src")[3])
    outside = next(p for p in range(d_bits.shape[0])
                   if p not in set(plan.to_descriptors().page_ids(spec, "dst")))
    if case == "inside":
        d_bits[page, 1] ^= 1
    elif case == "outside":
        d_bits[outside, 1] ^= 1
    elif case == "nan":                      # a NaN payload, the same bits on both sides
        s_bits[src_page, 1] = d_bits[page, 1] = nan
    elif case == "signed_zero":              # +0.0 sent, -0.0 landed
        s_bits[src_page, 1] = 0
        d_bits[page, 1] = 1 << (8 * np.dtype(uint).itemsize - 1)
    return src, dst, (rspec, rplan), (spec, plan)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,want", [("clean", True), ("inside", False), ("outside", True),
                                       ("nan", True), ("signed_zero", False)])
def test_verify_transfer_verdict_equals_reference(dtype, case, want):
    src, dst, (rspec, rplan), (spec, plan) = _verify_case(dtype, case)
    ref = RTR.verify_transfer(rplan, rspec, src, rspec, dst)
    tsrc, tdst = to_torch(src, "cpu"), to_torch(dst, "cpu")
    got = TR.verify_transfer(plan, spec, tsrc, spec, tdst)
    assert got == ref == want
    if case in ("nan", "signed_zero"):
        # a float comparison would give the other verdict
        pages = plan.to_descriptors()
        a = tsrc.reshape(-1, spec.payload)[torch.as_tensor(pages.page_ids(spec, "src"))]
        b = tdst.reshape(-1, spec.payload)[torch.as_tensor(pages.page_ids(spec, "dst"))]
        assert torch.equal(a, b) != want
