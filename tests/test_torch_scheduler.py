"""The port's Load-Aware Scheduler against the reference, case for case:
each of ``tests/test_scheduler.py``'s cases and ``tests/test_api.py``'s
controller-level flip-policy case runs the same inputs through both
packages' scheduler modules (``core/scheduler/*``, ``BlockManager``,
``Request``, the hardware profiles), keeps the reference test's own
assertions on each, and holds the two runs' traces equal, exactly:
scores, regimes, admission decisions with their ``retry_after``, routes,
the hooks fired, request states and the controller's ``events`` as
(cycle, kind, detail). No model runs here.
"""
import dataclasses
import itertools
import types

import pytest

torch = pytest.importorskip("torch")

from repro.core import block_manager as RBM  # noqa: E402
from repro.core import scheduler as RSC  # noqa: E402
from repro.core.scheduler import load_score as RLS  # noqa: E402
from repro.core.scheduler import metrics as RME  # noqa: E402
from repro.serving import request as RRQ  # noqa: E402
from repro.sim import hardware as RHW  # noqa: E402
from repro_torch.core import block_manager as BM  # noqa: E402
from repro_torch.core import scheduler as SC  # noqa: E402
from repro_torch.core.scheduler import load_score as LS  # noqa: E402
from repro_torch.core.scheduler import metrics as ME  # noqa: E402
from repro_torch.serving import request as RQ  # noqa: E402
from repro_torch.sim import hardware as HW  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pkg(sc, ls, me, bm, rq, hw):
    ns = types.SimpleNamespace(**{n: getattr(sc, n) for n in sc.__all__})
    ns.BlockManager = bm.BlockManager
    ns.DECODE_WEIGHTS, ns.PREFILL_WEIGHTS = ls.DECODE_WEIGHTS, ls.PREFILL_WEIGHTS
    ns.NodeStatus, ns.SlidingWindow, ns.normalize = \
        me.NodeStatus, me.SlidingWindow, me.normalize
    ns.Request, ns.RequestState, ns.SamplingParams = \
        rq.Request, rq.RequestState, rq.SamplingParams
    ns.A100, ns.H20, ns.L20 = hw.A100, hw.H20, hw.L20
    return ns


REF = _pkg(RSC, RLS, RME, RBM, RRQ, RHW)
PORT = _pkg(SC, LS, ME, BM, RQ, HW)


def both(case):
    """Run ``case`` on each package with the same request ids; the traces
    it returns must be equal."""
    traces = []
    for ns in (REF, PORT):
        ns.ids = itertools.count(7000)
        traces.append(case(ns))
    assert traces[0] == traces[1]
    return traces[1]


def _controller(ns, num_p=2, num_d=2, node_factory=None, **kw):
    mc = ns.ModelCost(flops_per_token=2 * 8e9, kv_bytes_per_token=131072.0,
                      weight_bytes=16e9)
    gc = ns.GlobalController(mc, block_size=32, node_factory=node_factory, **kw)
    for i in range(num_p + num_d):
        role = "prefill" if i < num_p else "decode"
        sched = ns.HybridScheduler(i, ns.BlockManager(512, 32), max_batch_tokens=4096)
        gc.register_node(ns.NodeHandle(i, role, host_id=i // 2, hardware=ns.A100,
                                       scheduler=sched))
    return gc


def _req(ns, n=100):
    return ns.Request(prompt_tokens=list(range(n)),
                      sampling=ns.SamplingParams(max_new_tokens=8), request_id=next(ns.ids))


def _events(gc):
    return [(e.cycle, e.kind, e.detail) for e in gc.events]


def _status(s):
    return dataclasses.astuple(s)


def _nodes(gc):
    return {n.node_id: (n.role, n.alive, n.home_role, n.switched_until_cycle,
                        n.scheduler.priority) for n in gc.nodes.values()}


# ---------------------------------------------------------------------------
# metrics / scores
# ---------------------------------------------------------------------------
def test_sliding_window_smooths():
    def case(ns):
        w = ns.SlidingWindow(window=4)
        for v in (0.0, 1.0, 1.0, 1.0):
            w.push(ns.NodeStatus(kv_utilization=v))
        out = w.smoothed()
        assert abs(out.kv_utilization - 0.75) < 1e-9
        return _status(out)
    both(case)


def test_normalize_bounds_queues():
    def case(ns):
        n1, n2 = ns.normalize([ns.NodeStatus(waiting_prefill=10),
                               ns.NodeStatus(waiting_prefill=5)])
        assert n1.waiting_prefill == 1.0 and n2.waiting_prefill == 0.5
        return _status(n1), _status(n2)
    both(case)


@pytest.mark.parametrize("preset", ["PREFILL_WEIGHTS", "DECODE_WEIGHTS"])
def test_score_weight_presets_are_convex(preset):
    """The shipped presets validate at import; validate() returns self."""
    def case(ns):
        w = getattr(ns, preset)
        assert w.validate() is w
        assert abs(sum(dataclasses.astuple(w)) - 1.0) < 1e-9
        return dataclasses.astuple(w)
    both(case)


@pytest.mark.parametrize("bad", ["sum", "negative"])
def test_score_weight_validation_rejects_drift(bad):
    def case(ns):
        p = ns.PREFILL_WEIGHTS
        w = (dataclasses.replace(p, waiting=0.9) if bad == "sum" else
             dataclasses.replace(p, waiting=-0.1, running=p.running + 0.4))
        with pytest.raises(ValueError, match="sum to 1" if bad == "sum" else "non-negative") \
                as err:
            w.validate()
        return str(err.value)
    both(case)


def test_capability_normalization_weak_node_scores_hotter():
    """Same load vector: a half-capability card reads as more loaded, and
    a full-capability card reproduces the original (unscaled) formula."""
    def case(ns):
        load = ns.NodeStatus(waiting_prefill=0.5, running_decode=0.5,
                             token_budget_used=0.5)
        weak_p = load.with_capability(0.5, 1.0, 1.0)
        weak_d = load.with_capability(1.0, 0.5, 1.0)
        scores = [ns.node_score(s, r) for s in (load, weak_p, weak_d)
                  for r in ("prefill", "decode")]
        assert ns.node_score(weak_p, "prefill") > ns.node_score(load, "prefill")
        assert ns.node_score(weak_d, "decode") > ns.node_score(load, "decode")
        util_only = ns.NodeStatus(kv_utilization=0.8, compute_utilization=0.8,
                                  bandwidth_utilization=0.8)
        scaled = ns.node_score(util_only.with_capability(0.5, 0.5, 0.5), "prefill")
        assert scaled == pytest.approx(ns.node_score(util_only, "prefill"))
        return scores, scaled
    both(case)


def test_controller_stamps_fleet_relative_capability():
    def case(ns):
        gc = _controller(ns, num_p=1, num_d=1)
        gc.nodes[0].hardware = ns.L20
        gc.nodes[1].hardware = ns.H20
        caps = gc._capabilities()
        assert caps[1][0] == 1.0 and caps[0][0] == pytest.approx(119 / 148, rel=1e-3)
        assert caps[1][1] == 1.0 and caps[0][1] < 0.25
        status = gc._scored_status(gc.nodes[0])
        assert status.capability_compute == caps[0][0]
        assert status.capability_memory == caps[0][1]
        return caps, _status(status)
    both(case)


def test_node_score_role_sensitivity():
    def case(ns):
        busy_p = ns.NodeStatus(waiting_prefill=1.0, compute_utilization=1.0,
                               token_budget_used=1.0)
        busy_d = ns.NodeStatus(running_decode=1.0, kv_utilization=1.0,
                               bandwidth_utilization=1.0)
        scores = [ns.node_score(s, r) for s in (busy_p, busy_d) for r in ("prefill", "decode")]
        assert scores[0] > scores[1] and scores[3] > scores[2]
        with pytest.raises(ValueError) as err:
            ns.node_score(busy_d, "bogus")
        return scores, str(err.value)
    both(case)


@pytest.mark.parametrize("cp,cd,want", [(0.1, 0.1, "normal"), (0.9, 0.1, "imbalanced"),
                                        (0.1, 0.9, "imbalanced"), (0.9, 0.9, "extreme")])
def test_classify_regimes(cp, cd, want):
    def case(ns):
        got = ns.classify_regime(cp, cd, ns.Thresholds())
        assert got == want
        return got
    both(case)


# ---------------------------------------------------------------------------
# routing (normal regime)
# ---------------------------------------------------------------------------
def test_routing_prefers_idle_prefill_node():
    def case(ns):
        gc = _controller(ns)
        for _ in range(5):
            gc.nodes[0].scheduler.enqueue_prefill(_req(ns))
        r = _req(ns)
        p, d = gc.route_request(r)
        assert p == 1 and d in (2, 3)
        return p, d, r.decode_node, _events(gc)
    both(case)


def test_routing_prefers_same_host_decode():
    def case(ns):
        gc = _controller(ns)
        r = _req(ns)
        p, d = gc.route_request(r)
        assert p in (0, 1) and d in (2, 3)
        return p, d
    both(case)


def _plan(r):
    return (r.num_cached_prefix_tokens, r.prefix_src_node, list(r.prefix_block_ids))


def test_prefix_cache_routing():
    def case(ns):
        gc = _controller(ns)
        tokens = list(range(640))
        gc.record_prefix(1, tokens, block_ids=list(range(100, 120)))
        r = ns.Request(prompt_tokens=tokens[:320], sampling=ns.SamplingParams(),
                       request_id=next(ns.ids))
        p, d = gc.route_request(r)
        assert p == 1
        assert _plan(r) == (288, 1, list(range(100, 109)))
        return p, d, _plan(r)
    both(case)


def test_prefix_routing_unbacked_entries_never_bill():
    """Entries recorded without block ids bias nothing."""
    def case(ns):
        gc = _controller(ns)
        tokens = list(range(640))
        gc.record_prefix(1, tokens)
        r = ns.Request(prompt_tokens=tokens[:320], sampling=ns.SamplingParams(),
                       request_id=next(ns.ids))
        route = gc.route_request(r)
        assert r.num_cached_prefix_tokens == 0 and r.prefix_src_node is None
        return route, _plan(r)
    both(case)


def test_prefix_routing_remote_fetch_plan():
    """A longer prefix on a decode node becomes a remote-fetch plan."""
    def case(ns):
        gc = _controller(ns, num_p=2, num_d=2)
        tokens = list(range(640))
        gc.record_prefix(3, tokens, block_ids=list(range(200, 220)))
        r = ns.Request(prompt_tokens=tokens, sampling=ns.SamplingParams(),
                       request_id=next(ns.ids))
        p, d = gc.route_request(r)
        assert r.prefix_src_node == 3 and p in (0, 1)
        assert _plan(r) == (608, 3, list(range(200, 219)))
        return p, d, _plan(r)
    both(case)


# ---------------------------------------------------------------------------
# imbalanced regime: role switching and the flip policy
# ---------------------------------------------------------------------------
def _flood(ns, gc, n=40, length=2000):
    for _ in range(n):
        gc.nodes[0].scheduler.enqueue_prefill(_req(ns, length))
    gc.nodes[0].scheduler.last_token_budget_used = 1.0
    gc.nodes[0].scheduler.last_compute_util = 1.0


def test_role_switch_on_imbalance():
    def case(ns):
        gc = _controller(ns, num_p=1, num_d=1)
        _flood(ns, gc)
        regimes = [gc.step() for _ in range(10)]
        assert regimes[-1] in ("imbalanced", "extreme")
        assert any(e.kind == "role_switch" for e in gc.events)
        assert gc.nodes[1].scheduler.priority == "prefill"
        return regimes, _events(gc), _nodes(gc)
    both(case)


def test_role_switch_lease_expires():
    def case(ns):
        s = ns.HybridScheduler(0, ns.BlockManager(64, 32))
        s.set_priority("decode", cycles=2)
        seen = [s.priority]
        s.schedule()
        s.schedule()
        seen.append(s.priority)
        assert seen == ["decode", "prefill"]
        return seen
    both(case)


def test_role_flip_policy_reassigns_and_reverts():
    """test_api.py's flip-policy case at the controller level: 1P+3D, the P
    node flooded; decode nodes flip to prefill, hold their residency, and
    return home once the load clears."""
    def case(ns):
        gc = _controller(ns, 1, 3, role_flip=True)
        _flood(ns, gc)
        trail = []
        for _ in range(30):
            trail.append((gc.step(), _nodes(gc)))
            if len(gc.prefill_nodes()) > 1:
                break
        assert len(gc.prefill_nodes()) > 1
        assert any(e.kind == "set_role" for e in gc.events)
        assert len(gc.decode_nodes()) >= 1
        flipped = [n for n in gc.prefill_nodes() if n.home_role == "decode"]
        for _ in range(gc.role_switch_cycles - 1):
            trail.append((gc.step(), _nodes(gc)))
            assert all(n.role == "prefill" for n in flipped)
        gc.nodes[0].scheduler.prefill.waiting.clear()
        gc.nodes[0].scheduler.last_token_budget_used = 0.0
        gc.nodes[0].scheduler.last_compute_util = 0.0
        for _ in range(40):
            trail.append((gc.step(), _nodes(gc)))
            if len(gc.decode_nodes()) == 3:
                break
        assert len(gc.decode_nodes()) == 3
        assert all(n.home_role is None for n in gc.nodes.values())
        return trail, _events(gc)
    both(case)


def test_role_flip_orders_by_capability():
    """On a heterogeneous fleet the flip borrows the most compute-rich idle
    decode node first (``_handle_imbalance``'s suitability): here the A100
    among declared H20, A100 and L20 decode nodes."""
    def case(ns):
        gc = _controller(ns, 1, 3, role_flip=True)
        for nid, hw in ((1, ns.H20), (2, ns.A100), (3, ns.L20)):
            gc.nodes[nid].hardware = hw
        caps = gc._capabilities()
        _flood(ns, gc)
        for _ in range(30):
            gc.step()
            if len(gc.prefill_nodes()) > 1:
                break
        flips = [e for e in gc.events if e.kind == "set_role"]
        richest = max((1, 2, 3), key=lambda nid: caps[nid][0])
        assert flips and flips[0].detail.startswith(f"node {richest}:")
        return caps, _events(gc)
    both(case)


# ---------------------------------------------------------------------------
# extreme regime: elastic scaling
# ---------------------------------------------------------------------------
def test_elastic_scale_up():
    def case(ns):
        created = []

        def factory(role):
            nid = 100 + len(created)
            h = ns.NodeHandle(nid, role, host_id=9, hardware=ns.A100,
                              scheduler=ns.HybridScheduler(nid, ns.BlockManager(512, 32)))
            created.append(h)
            return h

        gc = _controller(ns, num_p=1, num_d=1, node_factory=factory)
        for _ in range(60):
            gc.nodes[0].scheduler.enqueue_prefill(_req(ns, 4000))
            gc.nodes[1].scheduler.enqueue_decode(_req(ns, 100))
        gc.nodes[0].scheduler.schedule()
        for nid, util in ((0, "compute"), (1, "bandwidth")):
            sched = gc.nodes[nid].scheduler
            sched.last_token_budget_used = 1.0
            setattr(sched, f"last_{util}_util", 1.0)
        regimes = [gc.step() for _ in range(10)]
        assert created and any(e.kind == "scale_up" for e in gc.events)
        return regimes, [(h.node_id, h.role) for h in created], _events(gc)
    both(case)


def test_scale_down_removes_an_idle_node():
    """The low-load streak of ``step`` retires the least-loaded idle node of
    a role that has more than one (``_scale_down``)."""
    def case(ns):
        gc = _controller(ns, num_p=2, num_d=2)
        regimes = [gc.step() for _ in range(4 * gc.thresholds.scale_patience)]
        assert any(e.kind == "scale_down" for e in gc.events)
        return regimes, _events(gc), _nodes(gc)
    both(case)


# ---------------------------------------------------------------------------
# fault tolerance: heartbeat failover
# ---------------------------------------------------------------------------
def test_failover_requeues_requests():
    def case(ns):
        gc = _controller(ns, heartbeat_timeout=5.0)
        for nid in gc.nodes:
            gc.heartbeat(nid, 0.0)
        r = _req(ns)
        p, d = gc.route_request(r)
        for nid in gc.nodes:
            if nid != p:
                gc.heartbeat(nid, 100.0)
        failed = gc.detect_failures(now=100.0)
        assert p in failed and not gc.nodes[p].alive
        rerouted = gc.reroute_retries()
        assert rerouted == 0 or r.prefill_node != p
        assert r.retries >= 1 or r.prefill_node != p
        return (p, d, failed, rerouted, r.state.value, r.retries, r.prefill_node,
                r.decode_node, _events(gc))
    both(case)


# ---------------------------------------------------------------------------
# overload admission gate
# ---------------------------------------------------------------------------
def _decision(d):
    return (d.verdict, d.predicted_ttft_s, d.retry_after_s, d.reason, d.route)


def test_admission_disabled_admits_everything():
    def case(ns):
        d = _controller(ns).submit_request(_req(ns))
        assert d.admitted and d.route is not None
        return _decision(d)
    both(case)


def test_admission_rejects_on_predicted_ttft():
    def case(ns):
        pol = ns.AdmissionPolicy(ttft_slo_s=1e-12, reject_factor=1.0,
                                 retry_after_floor_s=2.5)
        gc = _controller(ns, admission=pol)
        r = _req(ns, 1000)
        d = gc.submit_request(r)
        assert d.verdict == "rejected" and r.state is ns.RequestState.REJECTED
        assert r.retry_after is not None and r.retry_after >= 2.5
        assert "predicted_ttft" in r.reject_reason
        assert gc.take_rejected() == [r] and gc.take_rejected() == []
        assert any(e.kind == "admission" for e in gc.events)
        return _decision(d), r.retry_after, r.reject_reason, _events(gc)
    both(case)


def test_admission_defers_then_rejects_when_load_persists():
    def case(ns):
        gc = _controller(ns, num_p=1, num_d=1,
                         admission=ns.AdmissionPolicy(max_queue_depth=1, max_defer_cycles=2))
        gc.nodes[0].scheduler.prefill.waiting.append(_req(ns))
        r = _req(ns)
        d = gc.submit_request(r)
        assert d.verdict == "deferred"
        assert r in gc.deferred and r.state is ns.RequestState.WAITING
        trail = []
        for _ in range(3):
            gc.step()
            trail.append((r.state.value, r.admission_defers, r.retry_after))
        assert r.state is ns.RequestState.REJECTED and r not in gc.deferred
        assert gc.take_rejected() == [r]
        return _decision(d), trail, r.reject_reason, _events(gc)
    both(case)


def test_admission_admits_deferred_once_load_drains():
    def case(ns):
        gc = _controller(ns, num_p=1, num_d=1,
                         admission=ns.AdmissionPolicy(max_queue_depth=1, max_defer_cycles=50))
        gc.nodes[0].scheduler.prefill.waiting.append(_req(ns))
        admitted = []
        gc.on_admit = admitted.append
        r = _req(ns)
        d = gc.submit_request(r)
        assert d.verdict == "deferred"
        gc.step()
        assert r in gc.deferred
        gc.nodes[0].scheduler.prefill.waiting.clear()
        gc.step()
        assert r not in gc.deferred and admitted == [r]
        assert r.prefill_node == 0 and r.retry_after is None
        assert r in gc.nodes[0].scheduler.prefill.waiting
        return _decision(d), r.admission_defers, r.decode_node, _events(gc)
    both(case)


def test_admission_overload_epsilon_gate():
    def case(ns):
        gc = _controller(ns, num_p=2, num_d=2,
                         admission=ns.AdmissionPolicy(max_queue_depth=1000, ttft_slo_s=1e9),
                         thresholds=ns.Thresholds(overload=0.05))
        for nid in (0, 1):
            sched = gc.nodes[nid].scheduler
            sched.last_token_budget_used = 1.0
            sched.last_compute_util = 1.0
            sched.sample_status()
        d = gc.submit_request(_req(ns))
        assert d.verdict == "deferred" and "eps_overload" in d.reason
        return _decision(d), _events(gc)
    both(case)


def test_passive_controller_takes_no_actions():
    def case(ns):
        gc = _controller(ns, num_p=1, num_d=1, actions_enabled=False,
                         admission=ns.AdmissionPolicy(ttft_slo_s=1e-12))
        d = gc.submit_request(_req(ns, 1000))
        assert d.admitted
        _flood(ns, gc)
        regimes = [gc.step() for _ in range(10)]
        kinds = {e.kind for e in gc.events}
        assert "role_switch" not in kinds and "scale_up" not in kinds
        assert "regime" in kinds
        return _decision(d), regimes, _events(gc)
    both(case)


# ---------------------------------------------------------------------------
# spill path: the swapped queue saves / restores KV through the hooks
# ---------------------------------------------------------------------------
def test_decode_preemption_spills_and_resumes_via_hooks():
    def case(ns):
        bm = ns.BlockManager(4, 4)
        s = ns.HybridScheduler(0, bm)
        spilled, resumed = [], []
        s.on_spill = lambda r: spilled.append(r.request_id)
        s.on_resume = lambda r: resumed.append(r.request_id)
        a, b = _req(ns, 7), _req(ns, 7)
        for r in (a, b):
            bm.allocate(r.request_id, r.total_len + 1)
            s.enqueue_decode(r)
        a.output_tokens.append(0)
        b.output_tokens.append(0)
        d = s.schedule()
        assert spilled == [a.request_id]
        assert a.state is ns.RequestState.SWAPPED and a in s.decode.swapped
        assert not bm.owns(a.request_id) and a.block_ids == []
        assert d.decode_batch == [b] and d.preempted == [a]
        s.decode_finished(b)
        d2 = s.schedule()
        assert resumed == [a.request_id]
        assert a.state is ns.RequestState.DECODING and d2.decode_batch == [a]
        assert bm.owns(a.request_id)
        table = list(bm.get(a.request_id))
        s.decode_finished(a)
        bm.check_invariants()
        assert bm.free_capacity == 4
        return (spilled, resumed, d.kind, d2.kind, table,
                [r.request_id for r in d.preempted])
    both(case)


def test_discard_hook_fires_on_cancel_and_drain():
    def case(ns):
        s = ns.HybridScheduler(0, ns.BlockManager(8, 4))
        discarded = []
        s.on_discard = lambda r: discarded.append(r.request_id)
        r1, r2 = _req(ns, 6), _req(ns, 6)
        s.enqueue_prefill(r1)
        s.enqueue_prefill(r2)
        s.remove_request(r1)
        assert r1.request_id in discarded
        drained = s.drain_for_failure()
        assert r2.request_id in discarded
        return discarded, [r.request_id for r in drained]
    both(case)


def test_scheduler_drain_for_failure_frees_blocks():
    def case(ns):
        bm = ns.BlockManager(64, 32)
        s = ns.HybridScheduler(0, bm)
        r = _req(ns, 64)
        s.enqueue_prefill(r)
        d = s.schedule()
        assert d.kind == "prefill" and bm.owns(r.request_id)
        table = list(bm.get(r.request_id))
        drained = s.drain_for_failure()
        assert r in drained and not bm.owns(r.request_id)
        bm.check_invariants()
        assert bm.free_capacity == 64
        return d.kind, dict(d.prefill_chunks), table, r.state.value
    both(case)
