"""The port's observability plane and the simulator cases left by the fault
plane and the host tier, on the CPU, against the reference.

* ``obs/calibrate.py``: the fits recover known coefficients and equal the
  reference's on the same samples; ``prefill_flops`` equals the reference's
  analytic count; the port's own prefill sweep times on the CPU, and the
  default device is the GPU (no fallback).
* ``obs/history.py``: record, check and schema cases (``tests/test_obs.py``),
  under ``tmp_path``.
* ``obs/replay.py``: replay determinism, and captures crossing the packages
  in both directions with equal ``per_request`` and ``stats``.
* The simulator's spans equal the reference's, span for span.
* ``tests/test_fault_tolerance.py:304-340``: the failure scenario's chaos
  gate, its determinism and the chaos capture/replay.
* ``tests/test_tiered_kv.py:388``: ``ClusterSim`` and the port's
  ``PDCluster`` (qwen3-1.7b smoke config, CPU) take the same tier-routing
  decision and emit the same ``tier_demote``/``tier_promote`` stream.
* ``launch/serve.py --engine sim``: the port's ``run_sim`` returns the
  reference's dict.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.obs import attach_tracer as ref_attach  # noqa: E402
from repro.obs import calibrate as ref_cal  # noqa: E402
from repro.obs import replay as ref_replay  # noqa: E402
from repro.sim.cluster_sim import ClusterSim as RefSim  # noqa: E402
from repro.sim.hardware import A100 as REF_A100  # noqa: E402
from repro.sim.workload import SIMULATED as REF_SIMULATED  # noqa: E402
from repro.sim.workload import generate as ref_generate  # noqa: E402
from repro_torch.configs import _REGISTRY, get_config, get_smoke_config  # noqa: E402
from repro_torch.core.costmodel import TransportProfile, predicted_ttft_s  # noqa: E402
from repro_torch.faults import FaultSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import attach_tracer, read_trace  # noqa: E402
from repro_torch.obs import calibrate as cal  # noqa: E402
from repro_torch.obs.history import AREAS, check, check_metrics, load, record  # noqa: E402
from repro_torch.obs.replay import capture, per_request_stats, replay  # noqa: E402
from repro_torch.obs.tracing import SpanRecorder, write_trace  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402
from repro_torch.sim.cluster_sim import ClusterSim  # noqa: E402
from repro_torch.sim.hardware import A100, TPU_V5E  # noqa: E402
from repro_torch.sim.scenarios import get_scenario  # noqa: E402
from repro_torch.sim.workload import SIMULATED, generate  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _requests(n=10, seed=3):
    return generate(dataclasses.replace(SIMULATED["1k"], num_requests=n), rps=2.0, seed=seed)


def _ref_requests(n=10, seed=3):
    return ref_generate(dataclasses.replace(REF_SIMULATED["1k"], num_requests=n),
                        rps=2.0, seed=seed)


# -- calibration ----------------------------------------------------------------------
def test_fit_transport_recovers_known_profile():
    truth = TransportProfile(name="truth", per_call_s=75e-6,
                             bandwidth_Bps=20e9, fixed_s=3e-4)
    rng = np.random.RandomState(0)
    samples = [(int(c), int(b), truth.latency(int(c), int(b)))
               for c, b in zip(rng.randint(1, 500, 12),
                               rng.randint(1 << 10, 1 << 28, 12))]
    fit = cal.fit_transport(samples)
    assert fit.per_call_s == pytest.approx(truth.per_call_s, rel=1e-6)
    assert fit.bandwidth_Bps == pytest.approx(truth.bandwidth_Bps, rel=1e-6)
    assert fit.fixed_s == pytest.approx(truth.fixed_s, rel=1e-6)
    ref = ref_cal.fit_transport(samples)
    assert (fit.per_call_s, fit.bandwidth_Bps, fit.fixed_s) == \
        (ref.per_call_s, ref.bandwidth_Bps, ref.fixed_s)
    with pytest.raises(ValueError, match=">= 3"):
        cal.fit_transport(samples[:2])


def test_fit_hardware_recovers_known_coefficients():
    eff_truth, ovh_truth = 150e9, 2.5e-3
    samples = [(f, ovh_truth + f / eff_truth) for f in (1e9, 5e9, 2e10, 1e11)]
    eff, ovh = cal.fit_compute(samples)
    assert eff == pytest.approx(eff_truth, rel=1e-6)
    assert ovh == pytest.approx(ovh_truth, rel=1e-6)
    assert (eff, ovh) == ref_cal.fit_compute(samples)
    hw = cal.fit_hardware(samples, base=A100, name="fit")
    ref = ref_cal.fit_hardware(samples, base=REF_A100, name="fit")
    assert (hw.mfu_prefill, hw.step_overhead_s) == (ref.mfu_prefill, ref.step_overhead_s)
    assert cal.fit_hardware(samples).peak_flops == TPU_V5E.peak_flops   # the default base
    for f, t in samples:
        assert hw.prefill_time(f) == pytest.approx(t, rel=1e-6)
        assert predicted_ttft_s(0.0, f, hw.peak_flops * hw.mfu_prefill,
                                hw.step_overhead_s) == pytest.approx(t, rel=1e-6)
    assert cal.TTFT_ERROR_BOUND == ref_cal.TTFT_ERROR_BOUND == 0.75


@pytest.mark.parametrize("arch", sorted(_REGISTRY))
def test_prefill_flops_equal_reference(arch):
    for port_cfg, ref_cfg in ((get_config(arch), ref_get_config(arch)),
                              (get_smoke_config(arch), ref_get_smoke(arch))):
        for n in (1, 100, 1500, 4096):
            assert cal.prefill_flops(port_cfg, n) == ref_cal.prefill_flops(ref_cfg, n)


def test_measure_prefill_on_cpu_and_no_fallback():
    cfg = get_smoke_config("qwen3-1.7b")
    samples = cal.measure_prefill(cfg, (16, 48), repeats=2, device="cpu")
    assert [f for f, _ in samples] == [cal.prefill_flops(cfg, 16), cal.prefill_flops(cfg, 48)]
    assert all(t > 0 for _, t in samples)
    res = cal.check(device="cpu")
    assert res["base"] == TPU_V5E.name and res["config"] == cfg.name
    assert res["prompt_lens"] == list(cal.CPU_PROMPT_LENS)
    assert len(res["held_out_rel_errors"]) == 4 and len(res["samples"]) == 8
    assert res["effective_flops"] == pytest.approx(TPU_V5E.peak_flops * res["mfu_prefill"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cal.measure_prefill(cfg, (16,), repeats=1)          # the default is the GPU
        with pytest.raises(RuntimeError, match="cuda"):
            cal.check()


# -- bench history ---------------------------------------------------------------------
def test_history_record_and_check(tmp_path):
    m = {"flowkv_calls": 1.0, "flowkv_dispatches": 1.0, "flowkv_wall_s": 0.1}
    record("transfer", m, root=tmp_path)
    data = load("transfer", root=tmp_path)
    assert data["baseline"] == m and len(data["entries"]) == 1
    record("transfer", dict(m), root=tmp_path)
    assert check("transfer", root=tmp_path) == []
    record("transfer", {**m, "flowkv_calls": 2.0}, root=tmp_path)
    failures = check("transfer", root=tmp_path)
    assert failures and "flowkv_calls" in failures[0]
    record("transfer", {**m, "flowkv_wall_s": 99.0}, root=tmp_path)
    assert check("transfer", root=tmp_path) == []


def test_history_modes_le_ge():
    base = {"imbalance_load_aware_goodput": 0.8,
            "imbalance_load_aware_p95_ttft_s": 10.0}
    assert check_metrics("scenarios", base, {
        "imbalance_load_aware_goodput": 0.79,
        "imbalance_load_aware_p95_ttft_s": 10.4}) == []
    assert len(check_metrics("scenarios", base, {
        "imbalance_load_aware_goodput": 0.7,
        "imbalance_load_aware_p95_ttft_s": 12.0})) == 2
    assert check_metrics("scenarios", base,
                         {"imbalance_load_aware_goodput": 0.8}) != []


def test_history_schema_guard(tmp_path):
    from repro.obs.history import AREAS as REF_AREAS

    p = tmp_path / "BENCH_transfer.json"
    p.write_text('{"schema": 999, "area": "transfer"}')
    with pytest.raises(ValueError, match="schema"):
        load("transfer", root=tmp_path)
    with pytest.raises(ValueError, match="unknown area"):
        record("nonsense", {}, root=tmp_path)
    assert {a: {k: (s.mode, s.tol) for k, s in specs.items()} for a, specs in AREAS.items()} \
        == {a: {k: (s.mode, s.tol) for k, s in specs.items()} for a, specs in REF_AREAS.items()}


# -- simulator spans -----------------------------------------------------------------
def _records(rec):
    return [s.to_record() for s in rec.spans]


def test_sim_spans_equal_reference():
    """Lifecycle spans (``test_obs.py:103``) and layer-window spans
    (``:125``), record for record equal to the reference's."""
    for kw, n, seed in (({}, 10, 3), (dict(same_host=False, layer_window=8), 4, 9)):
        sim = ClusterSim(get_config("llama31-8b"), "flowkv", num_prefill=1,
                         num_decode=1, **kw)
        rec = attach_tracer(sim)
        reqs = _requests(n=n, seed=seed)
        sim.run(reqs, t_max=50_000)
        ref = RefSim(ref_get_config("llama31-8b"), "flowkv", num_prefill=1,
                     num_decode=1, **kw)
        ref_rec = ref_attach(ref)
        ref_reqs = _ref_requests(n=n, seed=seed)
        ref.run(ref_reqs, t_max=50_000)
        ids = {r.request_id: p.request_id for r, p in zip(ref_reqs, reqs)}
        assert _records(rec) == [dict(r, trace_id=ids[r["trace_id"]])
                                 for r in _records(ref_rec)]
        for name in ("queue", "prefill", "transfer", "decode"):
            assert len(rec.by_name(name)) == n, name
        for r in reqs:
            spans = {s.name: s for s in rec.for_trace(r.request_id)}
            assert spans["queue"].end_cycle == spans["prefill"].start_cycle
            assert spans["transfer"].end_cycle == spans["decode"].start_cycle
        if kw:
            n_layers = sim.kv_spec.num_layers
            assert len(rec.by_name("transfer_layer_window")) == \
                -(-n_layers // 8) * len(rec.by_name("transfer"))
            assert any(s.attrs["hidden"] for s in rec.by_name("transfer_layer_window"))


# -- replay ---------------------------------------------------------------------------
def test_replay_is_deterministic(tmp_path):
    reqs = _requests()
    sim = ClusterSim(get_config("llama31-8b"), "flowkv", num_prefill=1, num_decode=1)
    path = tmp_path / "cap.jsonl"
    capture(sim, reqs, path=path, meta={"config": "llama31-8b"})
    r1 = replay(path, policy="load_aware")
    r2 = replay(path, policy="load_aware")
    assert r1["per_request"] == r2["per_request"]
    assert r1["stats"] == r2["stats"]
    assert r1["per_request"] == per_request_stats(reqs)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_trace_replays_across_packages(tmp_path, writer):
    """A capture written by either package replays in both, with equal
    per-request rows and stats, under the captured policy and another."""
    path = tmp_path / f"{writer}.jsonl"
    if writer == "port":
        sim = ClusterSim(get_config("llama31-8b"), "flowkv", num_prefill=2, num_decode=2)
        capture(sim, _requests(n=8, seed=5), path=path, meta={"config": "llama31-8b"})
    else:
        sim = RefSim(ref_get_config("llama31-8b"), "flowkv", num_prefill=2, num_decode=2)
        ref_replay.capture(sim, _ref_requests(n=8, seed=5), path=path,
                           meta={"config": "llama31-8b"})
    for policy in ("load_aware", "round_robin"):
        got, want = replay(path, policy=policy), ref_replay.replay(path, policy=policy)
        assert got["per_request"] == want["per_request"]
        assert got["stats"] == want["stats"]
        assert got["num_spans"] == want["num_spans"] > 0
        assert got["stats"]["offered"] == 8


def test_replay_rejects_spans_only_trace(tmp_path):
    rec = SpanRecorder()
    rec.emit(1, "queue", start_cycle=0.0, end_cycle=1.0)
    path = write_trace(tmp_path / "spans_only.jsonl", rec.spans)
    with pytest.raises(ValueError, match="request"):
        replay(path)


# -- the fault plane's simulator cases (test_fault_tolerance.py:304-340) ---------------
def test_sim_failure_scenario_meets_chaos_gate():
    sc = get_scenario("failure")
    chaos = sc.run("load_aware")
    clean = dataclasses.replace(sc, faults=()).run("load_aware")
    assert chaos["fault_kills"] == 1
    assert chaos["transfer_retries"] >= 1
    assert chaos["offered"] == chaos["finished"] + chaos["rejected"]
    assert chaos["leaked_blocks"] == 0
    assert chaos["goodput"] >= 0.7 * clean["goodput"]
    assert chaos == sc.run("load_aware")        # fresh injector per build: deterministic


def test_capture_replay_roundtrips_faults(tmp_path):
    reqs = _requests(n=10, seed=3)
    sim = ClusterSim(get_config("llama31-8b"), "flowkv", num_prefill=2, num_decode=2,
                     faults=[FaultSpec("node_crash", at=2.0, node_id=0),
                             FaultSpec("transfer_fail", at=0.0, count=2)],
                     heartbeat_timeout=1.0)
    path = tmp_path / "chaos.jsonl"
    stats, _ = capture(sim, reqs, path=path, meta={"config": "llama31-8b"})
    assert stats["fault_kills"] == 1
    trace = read_trace(path)
    assert trace.meta["faults"]["specs"]
    assert trace.meta["heartbeat_timeout"] == 1.0
    r1, r2 = replay(path), replay(path)
    assert r1["per_request"] == r2["per_request"]
    assert r1["stats"] == r2["stats"]
    assert r1["stats"]["fault_kills"] == stats["fault_kills"]
    assert r1["stats"]["transfer_retries"] == stats["transfer_retries"]
    assert r1["per_request"] == per_request_stats(reqs)
    want = ref_replay.replay(path)                     # the chaos replays in the reference
    assert want["per_request"] == r1["per_request"] and want["stats"] == r1["stats"]


# -- sim/real tier parity (test_tiered_kv.py:388) --------------------------------------
def _tier_spans(rec):
    return [(s.name, s.node_id, s.attrs["num_blocks"]) for s in rec.spans
            if s.name in ("tier_demote", "tier_promote")]


def test_sim_matches_engine_tier_decisions():
    """The port's ClusterSim and PDCluster, same config, pool shape and
    prompts, under the reference test's profiles (``TPU_V5E`` at 1e6 FLOP/s
    and the reference cluster's ``target="tpu"`` on the real side, ``A100``
    at 1e7 in the sim): the follower reuses the same prefix through a fetch,
    and the tier span streams are equal — also to the reference sim's."""
    cfg = get_smoke_config("qwen3-1.7b")
    params = T.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(21)
    donor = rng.randint(0, cfg.vocab_size, size=128).tolist()
    churn = rng.randint(0, cfg.vocab_size, size=416).tolist()
    follower = donor + rng.randint(0, cfg.vocab_size, size=64).tolist()
    prompts, new_tokens, arrivals = (donor, churn, follower), (8, 4, 4), (0.0, 400.0, 800.0)

    cluster = PDCluster(cfg, params, num_prefill=1, num_decode=1, num_blocks=16,
                        hardware=dataclasses.replace(TPU_V5E, peak_flops=1e6),
                        target="tpu", max_batch_tokens=4096, host_tier_blocks=64,
                        device="cpu")
    rec_real = attach_tracer(cluster)
    rreqs = []
    for p, n in zip(prompts, new_tokens):
        rreqs.append(Request(prompt_tokens=list(p), sampling=SamplingParams(max_new_tokens=n)))
        cluster.submit(rreqs[-1])
        for _ in range(400):
            cluster.step()
            if len(cluster.finished) >= len(rreqs):
                break
        assert len(cluster.finished) == len(rreqs), "stalled"
    assert cluster.audit_blocks() == 0
    cluster.assert_no_leaks()

    def run_sim(sim_cls, sim_cfg, hw, attach, request_cls, sampling_cls):
        sim = sim_cls(sim_cfg, "flowkv", num_prefill=1, num_decode=1,
                      hw_prefill=hw, hw_decode=hw, blocks_per_node=16, host_tier_blocks=64)
        rec = attach(sim)
        reqs = [request_cls(prompt_tokens=list(p), sampling=sampling_cls(max_new_tokens=n),
                            arrival_time=t) for p, n, t in zip(prompts, new_tokens, arrivals)]
        stats = sim.run(list(reqs), t_max=500_000)
        sim.audit_blocks()
        return reqs, stats, rec

    sreqs, sstats, rec_sim = run_sim(ClusterSim, cfg, dataclasses.replace(A100, peak_flops=1e7),
                                     attach_tracer, Request, SamplingParams)
    from repro.serving.request import Request as RefRequest
    from repro.serving.request import SamplingParams as RefSampling
    _, ref_stats, rec_ref = run_sim(RefSim, ref_get_smoke("qwen3-1.7b"),
                                    dataclasses.replace(REF_A100, peak_flops=1e7),
                                    ref_attach, RefRequest, RefSampling)

    assert rreqs[2].num_cached_prefix_tokens == sreqs[2].num_cached_prefix_tokens > 0
    assert cluster.stats()["prefix_fetches"] == sstats["prefix_fetches"] >= 1
    real_spans = _tier_spans(rec_real)
    assert real_spans == _tier_spans(rec_sim) == _tier_spans(rec_ref)
    assert any(n == "tier_demote" for n, _, _ in real_spans)
    assert any(n == "tier_promote" for n, _, _ in real_spans)
    assert sstats == ref_stats


# -- launch/serve.py --engine sim ------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--arch", "llama31-8b", "--system", "flowkv", "--workload", "1k", "--rps", "1.0"],
    ["--arch", "llama31-8b", "--system", "vllm_disagg", "--workload", "1k", "--rps", "2.0",
     "--hw-prefill", "l20", "--hw-decode", "h20", "--num-decode", "2", "--same-host"],
])
def test_engine_sim_equals_reference(argv, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --engine sim ...`` prints the
    reference launcher's stats for the same arguments."""
    out = []
    for main in (serve.main, ref_serve.main):
        monkeypatch.setattr("sys.argv", ["serve", "--engine", "sim", *argv])
        main()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    stats = json.loads(out[0])
    assert stats["finished"] == stats["offered"] > 0
