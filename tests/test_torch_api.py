"""The port's serving API (``serving/api.py`` over ``serving/cluster.py``
and ``serving/engine.py``) against the reference's, on the CPU: each of
``tests/test_api.py``'s client cases that no other port test holds
(streaming under the three schedules, result and stats, the run wrapper,
cancel on the decode node and in the queue, the set_role flip and its
validation, the overload burst with rejects and retry-after, deferral,
decode preemption's spill and resume, cancel while swapped, the dispatch
counts), plus a smoke-size ``examples/role_flip.py`` on 1P+3D with declared
H20 / H100 / A100 decode nodes.

Each case runs the reference's FlowKVClient and the port's on the same
prompts and request ids, on the qwen3-1.7b smoke config with the
reference's weights bridged, under the reference's profile and target
(``TPU_V5E``, ``"tpu"``). It keeps the reference test's own assertions on
each, and holds equal, exactly: tokens (and the port's monolithic
greedy_generate), request states, ``retry_after``, ``reject_reason``, the
controller's events as (cycle, kind, detail), and per request
``prefill_node``, ``decode_node``, ``transfer_calls`` and the cycle stamps.
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.scheduler import AdmissionPolicy as RefAdmission  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving import api as RAPI  # noqa: E402
from repro.serving import cluster as RCL  # noqa: E402
from repro.serving import request as RRQ  # noqa: E402
from repro.sim import hardware as RHW  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.scheduler import AdmissionPolicy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.bridge import from_reference  # noqa: E402
from repro_torch.serving import api as API  # noqa: E402
from repro_torch.serving import cluster as CL  # noqa: E402
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


# the port's H100 profile for the reference, which has none: A100's
# transports (IPC inside a host, NCCL across) with the H100's data sheet
REF_H100 = dataclasses.replace(RHW.A100, name=HW.H100.name, peak_flops=HW.H100.peak_flops,
                               hbm_bandwidth=HW.H100.hbm_bandwidth,
                               hbm_bytes=HW.H100.hbm_bytes)


@pytest.fixture(scope="module")
def sides():
    """Both packages' client factories and request types, over one set of
    weights (the reference's, bridged to the port)."""
    rcfg = ref_smoke("qwen3-1.7b")
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("qwen3-1.7b")
    params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    ref = types.SimpleNamespace(
        name="ref", rq=RRQ, Admission=RefAdmission, hw=RHW, h100=REF_H100,
        client=lambda hardware=RHW.TPU_V5E, **kw: RAPI.FlowKVClient(
            rcfg, rparams, hardware=hardware, **kw),
        cluster=lambda **kw: RCL.PDCluster(rcfg, rparams, hardware=RHW.TPU_V5E, **kw))
    port = types.SimpleNamespace(
        name="port", rq=RQ, Admission=AdmissionPolicy, hw=HW, h100=HW.H100,
        client=lambda hardware=HW.TPU_V5E, **kw: API.FlowKVClient(
            cfg, params, device="cpu", hardware=hardware, target="tpu", **kw),
        cluster=lambda **kw: CL.PDCluster(cfg, params, device="cpu", hardware=HW.TPU_V5E,
                                          target="tpu", **kw))
    greedy = {}

    def mono(prompt, steps):
        key = (tuple(prompt), steps)
        if key not in greedy:
            out = T.greedy_generate(params, cfg, torch.tensor([prompt], dtype=torch.int32),
                                    steps)
            greedy[key] = out[0].tolist()
        return greedy[key]

    for s in (ref, port):
        s.vocab, s.mono = cfg.vocab_size, mono
    return ref, port


def both(sides, case):
    """Run ``case`` on the reference and on the port with the same request
    ids; the traces it returns must be equal."""
    traces = []
    for s in sides:
        s.ids = itertools.count(9000)
        traces.append(case(s))
    assert traces[0] == traces[1]
    return traces[1]


def _prompts(vocab, n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=rng.randint(5, 30)))) for _ in range(n)]


def _fixed(vocab, n, size, seed):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=size))) for _ in range(n)]


def _submit(s, client, prompt, steps):
    return client.submit(s.rq.Request(prompt_tokens=list(prompt),
                                      sampling=s.rq.SamplingParams(max_new_tokens=steps),
                                      request_id=next(s.ids)))


def _req(r):
    return (r.request_id, r.state.value, list(map(int, r.output_tokens)), r.prefill_node,
            r.decode_node, r.transfer_calls, r.transfer_dispatches, r.retry_after,
            r.reject_reason, r.retries, r.admission_defers, r.prefill_end,
            r.first_token_time, r.transfer_end, r.finish_time, r.decode_steps)


def _events(client):
    return [(e.cycle, e.kind, e.detail) for e in client.controller.events]


def _stats(client):
    return {k: v for k, v in client.stats().items() if not k.endswith("wall_s")}


def _no_leaks(client, num_blocks):
    for eng in client.cluster.engines.values():
        eng.scheduler.bm.check_invariants()
        assert eng.scheduler.bm.free_capacity == num_blocks, "leaked blocks"


# ---------------------------------------------------------------------------
# streaming (test_api.py:49, :77, :97)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["flowkv", "layerwise", "blockwise"])
def test_streaming_matches_monolithic(sides, schedule):
    def case(s):
        prompts = _prompts(s.vocab)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=128,
                          transfer_schedule=schedule)
        handles = [_submit(s, client, p, 6) for p in prompts]
        streams = {h.request_id: [] for h in handles}
        iters = {h.request_id: h.tokens() for h in handles}
        saw_partial = False
        while iters:
            for rid, it in list(iters.items()):
                try:
                    streams[rid].append(int(next(it)))
                except StopIteration:
                    del iters[rid]
                    continue
                if not next(h for h in handles if h.request_id == rid).done:
                    saw_partial = True   # a token delivered before the request finished
        assert saw_partial, "streaming never yielded a token mid-flight"
        for h in handles:
            assert streams[h.request_id] == s.mono(h.request.prompt_tokens, 6)
            assert h.request.state is s.rq.RequestState.FINISHED
        return streams, [_req(h.request) for h in handles], _events(client), _stats(client)
    both(sides, case)


def test_result_and_stats_breakdown(sides):
    def case(s):
        [prompt] = _prompts(s.vocab, n=1, seed=11)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=64)
        h = _submit(s, client, prompt, 6)
        assert h.result() == s.mono(prompt, 6)
        st = h.stats()
        for key in ("queue_s", "prefill_s", "transfer_s", "decode_s", "ttft_s", "e2e_s"):
            assert st[key] is not None and st[key] >= 0.0, key
        assert h.request.first_token_time == h.request.prefill_end
        assert st["e2e_s"] >= st["ttft_s"]
        assert client.stats()["mean_ttft_cycles"] > 0.0
        return {k: v for k, v in st.items() if not k.endswith("wall_s")}, _stats(client)
    both(sides, case)


def test_run_wrapper_equals_streaming(sides):
    """PDCluster.run (the compat wrapper) and the handle API agree."""
    def case(s):
        prompts = _prompts(s.vocab, n=3, seed=21)
        cluster = s.cluster(num_prefill=1, num_decode=1, num_blocks=128)
        done = cluster.run([s.rq.Request(prompt_tokens=list(p), request_id=next(s.ids),
                                         sampling=s.rq.SamplingParams(max_new_tokens=5))
                            for p in prompts], max_cycles=80)
        batch = {tuple(r.prompt_tokens): list(map(int, r.output_tokens)) for r in done}
        client = s.client(num_prefill=1, num_decode=1, num_blocks=128)
        streamed = [list(map(int, _submit(s, client, p, 5).result())) for p in prompts]
        assert streamed == [batch[tuple(p)] for p in prompts]
        return streamed, [_req(r) for r in done]
    both(sides, case)


# ---------------------------------------------------------------------------
# cancel (test_api.py:115, :137)
# ---------------------------------------------------------------------------
def test_cancel_frees_blocks_on_decode_node(sides):
    def case(s):
        [prompt] = _prompts(s.vocab, n=1, seed=31)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=64)
        h = _submit(s, client, prompt, 200)
        cycles = 0
        while h.request.state is not s.rq.RequestState.DECODING:
            client.step()
            cycles += 1
        dnode = client.cluster.engines[h.request.decode_node]
        assert dnode.scheduler.bm.owns(h.request_id)
        table = list(dnode.scheduler.bm.get(h.request_id))
        assert h.cancel()
        assert h.cancelled and h.done
        for eng in client.cluster.engines.values():
            assert not eng.scheduler.bm.owns(h.request_id)
        _no_leaks(client, 64)
        assert not h.cancel()
        assert list(h.tokens()) == h.request.output_tokens
        return cycles, table, _req(h.request), _stats(client)
    both(sides, case)


def test_cancel_queued_request_before_prefill(sides):
    def case(s):
        long_prompt = _fixed(s.vocab, 1, 40, 41)[0]
        [other] = _prompts(s.vocab, n=1, seed=42)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=64, max_batch_tokens=8)
        h1 = _submit(s, client, long_prompt, 4)
        h2 = _submit(s, client, other, 4)
        client.step()
        assert h2.request.state is s.rq.RequestState.WAITING
        pnode = client.cluster.engines[h2.request.prefill_node]
        assert h2.request in pnode.scheduler.prefill.waiting
        assert h2.cancel()
        assert h2.request not in pnode.scheduler.prefill.waiting
        assert list(h2.tokens()) == []
        assert h1.result() == s.mono(long_prompt, 4)
        for eng in client.cluster.engines.values():
            assert not eng.scheduler.bm.owns(h2.request_id)
        _no_leaks(client, 64)
        assert client.cluster.submitted == 2
        assert len(client.cluster.finished) + len(client.cluster.cancelled) == 2
        return _req(h1.request), _req(h2.request), _stats(client)
    both(sides, case)


# ---------------------------------------------------------------------------
# node lifecycle: set_role (test_api.py:170, :261)
# ---------------------------------------------------------------------------
def test_set_role_flip_keeps_generation_token_correct(sides):
    def case(s):
        prompts = _prompts(s.vocab, n=6, seed=51)
        client = s.client(num_prefill=1, num_decode=2, num_blocks=128)
        first = [_submit(s, client, p, 5) for p in prompts[:3]]
        for _ in range(2):
            client.step()
        assert client.set_role(2, "prefill")
        assert client.controller.nodes[2].role == "prefill"
        assert any(e.kind == "set_role" for e in client.controller.events)
        second = [_submit(s, client, p, 5) for p in prompts[3:]]
        client.drain(max_cycles=200)
        for h in first + second:
            assert h.request.state is s.rq.RequestState.FINISHED
            assert h.request.output_tokens == s.mono(h.request.prompt_tokens, 5)
        _no_leaks(client, 128)
        return [_req(h.request) for h in first + second], _events(client), _stats(client)
    trace = both(sides, case)
    # the flipped node 2 prefilled part of the second wave
    assert any(r[3] == 2 for r in trace[0][3:])


def test_set_role_flip_back_and_validation(sides):
    def case(s):
        client = s.client(num_prefill=1, num_decode=1, num_blocks=64)
        got = [client.set_role(1, "prefill"), client.set_role(1, "prefill"),
               client.set_role(1, "decode")]
        assert got == [True, False, True]
        with pytest.raises(ValueError) as err:
            client.set_role(1, "bogus")
        return got, str(err.value), _events(client), \
            client.cluster.engines[1].scheduler.priority
    both(sides, case)


def test_local_handoff_on_an_all_prefill_fleet(sides):
    """With every node flipped to prefill, routing falls back to hybrid
    nodes and picks the prefill node itself as the decode node (its own
    host is the cheapest route): the cache hands off in place with no
    transfer (serving/cluster.py's ``src is dst`` branch) and decodes from
    the same pool."""
    def case(s):
        prompts = _prompts(s.vocab, n=3, seed=57)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=64)
        assert client.set_role(1, "prefill")
        handles = [_submit(s, client, p, 4) for p in prompts]
        client.drain(max_cycles=100)
        for h in handles:
            r = h.request
            assert r.output_tokens == s.mono(r.prompt_tokens, 4)
            assert r.prefill_node == r.decode_node
            assert r.transfer_calls == r.transfer_dispatches == 0
        assert client.stats()["transfers"] == 0
        _no_leaks(client, 64)
        return [_req(h.request) for h in handles], _events(client), _stats(client)
    both(sides, case)


# ---------------------------------------------------------------------------
# overload admission (test_api.py:323, :367)
# ---------------------------------------------------------------------------
def test_overload_burst_rejected_with_retry_after(sides):
    def case(s):
        prompts = _prompts(s.vocab, n=8, seed=71)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=128, max_batch_tokens=8,
                          admission=s.Admission(max_queue_depth=2, max_defer_cycles=3,
                                                retry_after_floor_s=2.0))
        handles = [_submit(s, client, p, 3) for p in prompts]
        client.drain(max_cycles=500)
        rejected = [h for h in handles if h.rejected]
        served = [h for h in handles if not h.rejected]
        assert rejected and served
        for h in rejected:
            assert h.done and h.state is s.rq.RequestState.REJECTED
            assert h.retry_after is not None and h.retry_after >= 2.0
            st = h.stats()
            assert st["retry_after_s"] == h.retry_after and st["reject_reason"]
            assert list(h.tokens()) == []
            assert not h.cancel()
        for h in served:
            assert h.request.state is s.rq.RequestState.FINISHED
            assert h.request.output_tokens == s.mono(h.request.prompt_tokens, 3)
        st = client.stats()
        assert st["rejected"] == len(rejected) and st["deferred"] == 0
        assert client.cluster.submitted == len(prompts)
        _no_leaks(client, 128)
        for _ in range(3):
            client.step()
        retries = [_submit(s, client, h.request.prompt_tokens, 3) for h in rejected]
        client.drain(max_cycles=500)
        for h in retries:
            assert h.request.state is s.rq.RequestState.FINISHED
            assert h.request.output_tokens == s.mono(h.request.prompt_tokens, 3)
        return ([_req(h.request) for h in handles + retries], _events(client),
                _stats(client))
    both(sides, case)


def test_deferred_request_admitted_once_load_drains(sides):
    def case(s):
        prompts = _prompts(s.vocab, n=3, seed=81)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=128, max_batch_tokens=8,
                          admission=s.Admission(max_queue_depth=2, max_defer_cycles=200))
        handles = [_submit(s, client, p, 3) for p in prompts]
        assert handles[-1].request in client.controller.deferred
        client.drain(max_cycles=500)
        for h in handles:
            assert h.request.state is s.rq.RequestState.FINISHED
            assert h.request.output_tokens == s.mono(h.request.prompt_tokens, 3)
        assert client.stats()["rejected"] == 0
        return [_req(h.request) for h in handles], _events(client), _stats(client)
    both(sides, case)


def test_cancel_deferred_request(sides):
    """A request parked by the gate is cancelled before admission: it leaves
    the controller's deferred queue and the others finish."""
    def case(s):
        prompts = _prompts(s.vocab, n=3, seed=83)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=128, max_batch_tokens=8,
                          admission=s.Admission(max_queue_depth=2, max_defer_cycles=200))
        handles = [_submit(s, client, p, 3) for p in prompts]
        parked = handles[-1]
        assert parked.request in client.controller.deferred
        assert parked.cancel() and parked.cancelled
        assert parked.request not in client.controller.deferred
        client.drain(max_cycles=500)
        for h in handles[:-1]:
            assert h.request.output_tokens == s.mono(h.request.prompt_tokens, 3)
        _no_leaks(client, 128)
        return [_req(h.request) for h in handles], _events(client), _stats(client)
    both(sides, case)


# ---------------------------------------------------------------------------
# decode preemption (test_api.py:390, :421)
# ---------------------------------------------------------------------------
def _swap_trail(s, client, handles, stop_at_swap):
    trail = []
    for _ in range(400):
        client.step()
        trail.append(tuple(h.request.state.value for h in handles))
        swapped = next((h for h in handles
                        if h.request.state is s.rq.RequestState.SWAPPED), None)
        if (stop_at_swap and swapped is not None) or all(h.done for h in handles):
            return trail, swapped
    raise AssertionError("the cluster never settled")


def test_decode_preemption_spill_resume_token_identical(sides):
    def case(s):
        prompts = _fixed(s.vocab, 2, 20, 7)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=3)
        handles = [_submit(s, client, p, 20) for p in prompts]
        trail, _ = _swap_trail(s, client, handles, stop_at_swap=False)
        assert any("swapped" in states for states in trail)
        for h in handles:
            assert h.request.state is s.rq.RequestState.FINISHED
            assert h.request.output_tokens == s.mono(h.request.prompt_tokens, 20)
            assert h.request.retries == 0
        _no_leaks(client, 3)
        for eng in client.cluster.engines.values():
            assert not eng.spilled, "a saved spill was never consumed"
        return trail, [_req(h.request) for h in handles], _events(client), _stats(client)
    both(sides, case)


def test_cancel_while_swapped_discards_spill(sides):
    def case(s):
        prompts = _fixed(s.vocab, 2, 20, 9)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=3)
        handles = [_submit(s, client, p, 20) for p in prompts]
        trail, target = _swap_trail(s, client, handles, stop_at_swap=True)
        assert target is not None
        dnode = client.cluster.engines[target.request.decode_node]
        k, v, length = dnode.spilled[target.request_id]
        spill = (np.asarray(k, np.float32), np.asarray(v, np.float32), length)
        assert target.cancel()
        assert target.request_id not in dnode.spilled
        client.drain(max_cycles=400)
        _no_leaks(client, 3)
        other = next(h for h in handles if h is not target)
        assert other.request.output_tokens == s.mono(other.request.prompt_tokens, 20)
        return trail, spill, [_req(h.request) for h in handles], _events(client)

    traces = []
    for s in sides:
        s.ids = itertools.count(9000)
        traces.append(case(s))
    (t_r, sp_r, reqs_r, ev_r), (t_p, sp_p, reqs_p, ev_p) = traces
    assert (t_r, reqs_r, ev_r) == (t_p, reqs_p, ev_p)
    # the spilled K/V itself: the same positions, the same values
    assert sp_r[2] == sp_p[2]
    np.testing.assert_allclose(sp_p[0], sp_r[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(sp_p[1], sp_r[1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# data-plane counters (test_api.py:451)
# ---------------------------------------------------------------------------
def test_stats_expose_transfer_dispatch_counts(sides):
    def case(s):
        [prompt] = _prompts(s.vocab, n=1, seed=61)
        client = s.client(num_prefill=1, num_decode=1, num_blocks=64,
                          transfer_schedule="layerwise")
        h = _submit(s, client, prompt, 3)
        h.result()
        st = h.stats()
        assert st["num_dispatches"] == 1
        assert st["num_calls"] >= 2 * 2
        assert st["num_calls"] == client.cluster.transfers[-1].num_calls
        assert client.stats()["mean_transfer_dispatches"] == 1.0
        return st["num_calls"], st["num_dispatches"], _stats(client)
    both(sides, case)


# ---------------------------------------------------------------------------
# examples/role_flip.py at smoke size, on a heterogeneous fleet
# ---------------------------------------------------------------------------
def test_role_flip_heterogeneous_fleet(sides):
    """1P+3D, ``role_flip=True``, the prefill node an H100 and the decode
    nodes declared H20, H100 and A100: a prefill-heavy burst flips idle
    decode nodes to prefill, the most compute-rich one first (read from
    ``_capabilities()``), later arrivals prefill on a flipped node, every
    node returns home once the burst drains, and every request decodes
    the monolithic tokens. The flip order, every event and every request's
    route equal the reference's."""
    def case(s):
        hw = {0: s.h100, 1: s.hw.H20, 2: s.h100, 3: s.hw.A100}
        client = s.client(num_prefill=1, num_decode=3, num_blocks=256,
                          max_batch_tokens=256, role_flip=True, hardware=hw)
        rng = np.random.RandomState(7)
        prompts = [list(map(int, rng.randint(0, s.vocab, size=rng.randint(120, 200))))
                   for _ in range(16)]
        caps = client.controller._capabilities()
        handles = [_submit(s, client, p, 4) for p in prompts[:8]]
        for p in prompts[8:]:                  # the burst's tail arrives a cycle apart
            client.step()
            handles.append(_submit(s, client, p, 4))
        client.drain(max_cycles=400)
        flips = [e for e in client.controller.events if e.kind == "set_role"]
        assert flips, "the flip policy never reassigned a decode node"
        idle_decode = [1, 2, 3]
        richest = max(idle_decode, key=lambda nid: caps[nid][0])
        assert flips[0].detail == f"node {richest}: decode -> prefill"
        assert any(h.request.prefill_node not in (0,) for h in handles), \
            "no request prefilled on a flipped node"
        for _ in range(40):
            client.step()
            if all(n.role == ("prefill" if n.node_id == 0 else "decode")
                   for n in client.controller.nodes.values()):
                break
        for n in client.controller.nodes.values():
            assert n.role == ("prefill" if n.node_id == 0 else "decode")
            # a borrowed node that the reverse (decode-hot) imbalance sends
            # home keeps home_role == its role in both packages (ROADMAP
            # queue 3); one the flip-back returns has it cleared
            assert n.home_role in (None, n.role)
        for h in handles:
            assert h.request.output_tokens == s.mono(h.request.prompt_tokens, 4)
        _no_leaks(client, 256)
        return caps, [_req(h.request) for h in handles], _events(client), _stats(client)
    both(sides, case)
