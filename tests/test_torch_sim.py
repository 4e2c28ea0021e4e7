"""The port's cluster simulator against the reference's, on the CPU.

``repro_torch/sim`` is a copy of ``repro/sim`` over the port's control plane
(the scheduler, block manager, global controller, fault plane and host tier
are copies too), so every stats dict must EQUAL the reference's — the same
code in the same order of float operations. This file holds the seven
registered scenarios under ``load_aware`` and the cases of
``tests/test_sim.py`` that the runs up to 10k tokens serve; the
heterogeneous-fleet, saturation, colocated and role-switch cases are in
``test_torch_sim_trends.py``. Each reference run is made once per module
(``_stats``' cache) and each paper-trend assertion of ``test_sim.py`` is
made on the port's stats.
"""
import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.sim import cluster_sim as ref_cs  # noqa: E402
from repro.sim import hardware as ref_hw  # noqa: E402
from repro.sim import scenarios as ref_sc  # noqa: E402
from repro.sim import workload as ref_wl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.sim import cluster_sim as cs  # noqa: E402
from repro_torch.sim import hardware as hw  # noqa: E402
from repro_torch.sim import scenarios as sc  # noqa: E402
from repro_torch.sim import workload as wl  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(get_config=ref_get_config, cs=ref_cs, hw=ref_hw,
                                 sc=ref_sc, wl=ref_wl),
    "port": types.SimpleNamespace(get_config=get_config, cs=cs, hw=hw, sc=sc, wl=wl),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _sim(pkg, kind, wl_name="10k", rps=1.0, num_requests=None, t_max=50_000,
         seed=0, **kw):
    """One ClusterSim run of ``test_sim.py``'s ``_run`` in package ``pkg``;
    hardware is named (``hw_prefill="l20"``, ``hw_nodes=("a100", ...)``) and
    resolved in that package. Returns (sim, stats), cached per module."""
    p = PKGS[pkg]
    for key in ("hw_prefill", "hw_decode"):
        if key in kw:
            kw[key] = p.hw.get_hardware(kw[key])
    if "hw_nodes" in kw:
        kw["hw_nodes"] = tuple(p.hw.get_hardware(n) for n in kw["hw_nodes"])
    spec = {**p.wl.SIMULATED, **p.wl.LONGBENCH}[wl_name]
    if num_requests is not None:
        spec = dataclasses.replace(spec, num_requests=num_requests)
    sim = p.cs.ClusterSim(p.get_config("llama31-8b"), kind, **kw)
    return sim, sim.run(p.wl.generate(spec, rps=rps, seed=seed), t_max=t_max)


def _stats(kind, **kw):
    """The port's stats for one run, held equal to the reference's."""
    port = _sim("port", kind, **kw)[1]
    assert port == _sim("ref", kind, **kw)[1], (kind, kw)
    return port


@functools.lru_cache(maxsize=None)
def _scenario(pkg, name, policy):
    return PKGS[pkg].sc.get_scenario(name).run(policy)


# ---------------------------------------------------------------------------
# the registered scenarios: equal stats under load_aware
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ref_sc.SCENARIOS))
def test_scenario_stats_equal_reference(name):
    port = _scenario("port", name, "load_aware")
    assert port == _scenario("ref", name, "load_aware")
    assert port["offered"] == port["finished"] + port["rejected"] > 0


def test_overload_scenario_gate_smoke():
    la = _scenario("port", "overload", "load_aware")
    rr = _scenario("port", "overload", "round_robin")
    assert rr == _scenario("ref", "overload", "round_robin")
    assert la["rejected"] > 0
    assert rr["rejected"] == 0
    assert la["goodput"] >= rr["goodput"]
    assert la["p95_ttft_s"] <= rr["p95_ttft_s"]
    assert la["finished"] + la["rejected"] == la["offered"] == \
        sc.get_scenario("overload").num_requests


def test_scenario_registry_complete():
    assert set(sc.SCENARIOS) == set(ref_sc.SCENARIOS) == {
        "normal", "imbalance", "overload", "heterogeneous", "failure",
        "multiturn", "sharded_heterogeneous"}
    for name, s in sc.SCENARIOS.items():
        r = ref_sc.SCENARIOS[name]
        assert s.name == name and s.description == r.description
        assert (s.num_prefill, s.num_decode, s.rps, s.num_requests, s.seed) == \
            (r.num_prefill, r.num_decode, r.rps, r.num_requests, r.seed)
    with pytest.raises(ValueError, match="unknown scenario"):
        sc.get_scenario("nope")


# ---------------------------------------------------------------------------
# test_sim.py's cases on the port
# ---------------------------------------------------------------------------
def test_flowkv_beats_vllm_disagg_at_load():
    fk = _stats("flowkv")
    vd = _stats("vllm_disagg")
    assert fk["finished"] == vd["finished"] == 100
    assert fk["throughput_tok_s"] > 1.2 * vd["throughput_tok_s"]
    assert fk["mean_transfer_calls"] == 1.0
    assert vd["mean_transfer_calls"] == 64.0          # 2L for llama31-8b


def test_flowkv_transfer_latency_negligible():
    fk = _stats("flowkv")
    assert fk["mean_transfer_s"] < 0.1
    vd = _stats("vllm_disagg")
    assert vd["mean_transfer_s"] > 10 * fk["mean_transfer_s"]


def test_sim_dispatch_counts_from_descriptor_tables():
    for kind in ("flowkv", "vllm_disagg"):
        assert _stats(kind)["mean_transfer_dispatches"] == 1.0, kind


def test_baseline_routing_policies_are_passive():
    for routing in ("round_robin", "static_pd"):
        stats = _stats("flowkv", wl_name="1k", num_requests=20, rps=3.0,
                       t_max=20_000, num_prefill=1, num_decode=3, routing=routing)
        sim = _sim("port", "flowkv", wl_name="1k", num_requests=20, rps=3.0,
                   t_max=20_000, num_prefill=1, num_decode=3, routing=routing)[0]
        assert not sim.controller.actions_enabled
        assert stats["finished"] == 20
        kinds = {e.kind for e in sim.controller.events}
        assert "role_switch" not in kinds and "set_role" not in kinds
    with pytest.raises(ValueError, match="routing"):
        cs.ClusterSim(get_config("llama31-8b"), "flowkv", routing="bogus")


def test_round_robin_rotates_both_sides():
    kw = dict(wl_name="1k", num_requests=8, rps=0.2, t_max=20_000,
              num_prefill=2, num_decode=2, routing="round_robin")
    _stats("flowkv", **kw)
    sim = _sim("port", "flowkv", **kw)[0]
    assert all(n.served_prefill + n.served_decode > 0 for n in sim.nodes.values())


def test_hw_nodes_mixed_fleet_and_length_check():
    cfg = get_config("llama31-8b")
    sim = cs.ClusterSim(cfg, "flowkv", num_prefill=2, num_decode=2,
                        hw_nodes=(hw.A100, hw.L20, hw.A100, hw.H20))
    assert sim.nodes[1].hw is hw.L20 and sim.nodes[3].hw is hw.H20
    caps = sim.controller._capabilities()
    assert caps[0] == (1.0, pytest.approx(0.5), pytest.approx(80 / 96))
    ref = ref_cs.ClusterSim(ref_get_config("llama31-8b"), "flowkv", num_prefill=2,
                            num_decode=2, hw_nodes=(ref_hw.A100, ref_hw.L20,
                                                    ref_hw.A100, ref_hw.H20))
    assert caps == ref.controller._capabilities()
    with pytest.raises(ValueError, match="hw_nodes"):
        cs.ClusterSim(cfg, "flowkv", num_prefill=1, num_decode=1, hw_nodes=(hw.A100,))


def _shapes(reqs):
    return [(r.request_id, r.prompt_tokens, r.sampling.max_new_tokens, r.arrival_time)
            for r in reqs]


def test_generate_mixture_draws_from_both_specs():
    heavy, light = wl.WorkloadSpec("h", 4096, 16), wl.WorkloadSpec("l", 64, 256)
    reqs = wl.generate_mixture([heavy, light], [0.5, 0.5], rps=1.0,
                               num_requests=60, seed=3)
    assert len(reqs) == 60
    assert {r.prompt_len > 1000 for r in reqs} == {True, False}
    assert all(reqs[i].arrival_time <= reqs[i + 1].arrival_time
               for i in range(len(reqs) - 1))
    ref = ref_wl.generate_mixture([ref_wl.WorkloadSpec("h", 4096, 16),
                                   ref_wl.WorkloadSpec("l", 64, 256)], [0.5, 0.5],
                                  rps=1.0, num_requests=60, seed=3)
    assert [s[1:] for s in _shapes(reqs)] == [s[1:] for s in _shapes(ref)]


@pytest.mark.parametrize("name", sorted(ref_wl.SIMULATED))
def test_workload_requests_equal_reference(name):
    """Both packages draw the same requests from one seed (numpy)."""
    spec = dataclasses.replace(wl.SIMULATED[name], num_requests=12)
    ref_spec = dataclasses.replace(ref_wl.SIMULATED[name], num_requests=12)
    got = wl.generate(spec, rps=2.0, seed=5)
    want = ref_wl.generate(ref_spec, rps=2.0, seed=5)
    assert [s[1:] for s in _shapes(got)] == [s[1:] for s in _shapes(want)]
