"""The engine's phase spans on the device's clock (``flowbench/phases.py``)
and the five metrics that read them, on a synthetic slice against values
worked out by hand; a program without the spans' stamps gives them nothing;
a traced rehearsal on the CPU reads the span metrics from the program."""
import json
import pathlib
import sys
import time
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from flowbench import flops, harness, phases, rehearsal  # noqa: E402
from repro_torch.obs.tracing import Span  # noqa: E402

CFG = json.loads((ROOT / "flowbench" / "configs" / "qwen3-1.7b.json").read_text())
H100 = flops.peaks("NVIDIA H100 80GB HBM3")
METRICS = ("decode_step_p50_ms.qa", "decode_host_p50_ms.qa", "decode_pad_pct.qa",
           "launch_idle_pct.qa", "k3_roofline.qa")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name, run):
    return harness.load_module(ROOT / "flowbench" / "metrics" / f"{name}.py", name).read(run)


def _step(t, upload, launch, readback, post, end, batch, lanes, ctx):
    return Span(-1, "decode_step", start_wall_s=t, end_wall_s=end, node_id=1,
                attrs={"batch": batch, "lanes": lanes, "width": 8, "context_tokens": ctx,
                       "t_upload": upload, "t_launch": launch, "t_readback": readback,
                       "t_post": post})


def _slice_run():
    """The window [0, 12] s, the profiler from 10 s; the slice [10, 12] s
    of the host's clock is [5, 7] s of the device's."""
    run = harness.Run(cell=types.SimpleNamespace(cfg=CFG, mix={"loop": "open"}), peak=H100)
    run.t_start, run.t_end, run.traced_from = 0.0, 12.0, 10.0
    run.slice_mono, run.slice_ns = (10.0, 12.0), (5_000_000_000, 7_000_000_000)
    run.spans = [
        _step(-1.0, -0.99, -0.98, -0.97, -0.96, -0.95, 1, 8, 50),      # before the window
        # walls 32 / 50 / 40 ms; host's own time 2+7+2 / 1+15+29 / 3+20+15 ms
        _step(1.0, 1.002, 1.003, 1.010, 1.030, 1.032, 3, 4, 300),
        _step(2.0, 2.001, 2.005, 2.020, 2.021, 2.050, 16, 16, 1000),
        _step(3.0, 3.003, 3.004, 3.024, 3.025, 3.040, 5, 8, 700),
        _step(9.99, 9.991, 9.992, 9.993, 9.994, 10.01, 1, 2, 10),      # reaches the slice
        # the slice's steps: launch [10.502, 10.6] and [11.002, 11.1]
        _step(10.5, 10.501, 10.502, 10.6, 10.7, 10.8, 2, 2, 5000),
        _step(11.0, 11.001, 11.002, 11.1, 11.101, 11.11, 3, 4, 7000),
        # a chunk in the slice, launch [11.3, 11.5]; not final: no readback
        Span(4, "prefill_chunk", start_wall_s=11.2, end_wall_s=11.6, node_id=0,
             attrs={"offset": 2048, "tokens": 2048, "prompt_len": 6000, "final": False,
                    "t_upload": 11.25, "t_launch": 11.3, "t_write": 11.5}),
    ]
    run.device_records = [
        ("paged_decode_split_kernel", 5_550_000_000, 5_580_000_000),   # 30 ms in a launch
        ("paged_decode_split_kernel", 6_000_000_000, 6_050_000_000),   # 48 ms in a launch
        ("nvjet_gemm", 6_350_000_000, 6_600_000_000),                  # 150 ms in a launch
    ]
    return run


def test_stamps_map_onto_the_device_clock():
    run = _slice_run()
    assert phases.to_device_ns(run, 10.0) == 5_000_000_000
    assert phases.to_device_ns(run, 10.502) == 5_502_000_000
    assert phases.to_device_ns(run, 9.5) == 4_500_000_000
    ph = phases.phases(run.spans[1])
    assert [p for p, _, _ in ph] == ["prep", "upload", "launch", "readback", "post"]
    assert [(a, b) for _, a, b in ph] == [(1.0, 1.002), (1.002, 1.003), (1.003, 1.010),
                                         (1.010, 1.030), (1.030, 1.032)]
    assert [p for p, _, _ in phases.phases(run.spans[-1])] == \
        ["prep", "upload", "launch", "write"]
    launches = phases.host_intervals(run, "launch")
    assert launches == [("decode.launch", 4_992_000_000, 4_993_000_000),
                        ("decode.launch", 5_502_000_000, 5_600_000_000),
                        ("decode.launch", 6_002_000_000, 6_100_000_000),
                        ("prefill.launch", 6_300_000_000, 6_500_000_000)]
    # a slice the harness moved onto the records' clock moves the stamps with it
    run.slice_ns = (8_000_000_000, 10_000_000_000)
    assert phases.to_device_ns(run, 10.502) == 8_502_000_000
    # the end pair 2 ms later on the records' clock: a stamp moves in proportion
    run.slice_ns = (8_000_000_000, 10_002_000_000)
    assert phases.to_device_ns(run, 10.0) == 8_000_000_000
    assert phases.to_device_ns(run, 11.0) == 9_001_000_000
    assert phases.to_device_ns(run, 12.0) == 10_002_000_000
    assert phases.to_device_ns(run, 9.0) == 6_999_000_000


def test_launch_idle_pct_on_a_synthetic_slice():
    run = _slice_run()
    # idle in the launches: 98 - 30, 98 - 48, 200 - 150 ms; the step that
    # reaches into the slice launched before it
    assert _read("launch_idle_pct.qa", run) == pytest.approx(100 * 0.168 / 2.0)
    by_phase = phases.idle_by_phase(run)
    assert by_phase["decode.launch"] == pytest.approx(0.118)
    assert by_phase["prefill.launch"] == pytest.approx(0.05)
    assert by_phase["decode.readback"] == pytest.approx(0.1 + 0.001)
    # the step reaching into the slice: 10 ms of its post phase
    assert by_phase["decode.post"] == pytest.approx(0.01 + 0.1 + 0.009)
    assert by_phase["prefill.prep"] == by_phase["prefill.upload"] == pytest.approx(0.05)
    assert "prefill.write" not in by_phase                   # the GEMM ran under it
    # of the slice's 1.67 s of idle, 0.49 s lay under a phase
    assert sum(by_phase.values()) == pytest.approx(0.06 + 0.22 + 0.21)


def test_k3_roofline_on_a_synthetic_slice():
    run = _slice_run()
    ctx = 5000 + 7000                    # the two steps wholly in the slice
    least = max(ctx * 114_688 / 3.35e12, ctx * 4 * 28 * 16 * 128 / 989e12)
    assert _read("k3_roofline.qa", run) == pytest.approx(100 * least / 0.08)
    run.device_records = []
    assert _read("k3_roofline.qa", run) is None
    assert _read("launch_idle_pct.qa", run) is None


def test_decode_pad_and_step_walls_on_a_synthetic_window():
    run = _slice_run()
    # the three steps inside the window before the profiler
    assert _read("decode_pad_pct.qa", run) == pytest.approx(100 * (1 + 0 + 3) / (4 + 16 + 8))
    assert _read("decode_step_p50_ms.qa", run) == pytest.approx(40.0)
    assert _read("decode_host_p50_ms.qa", run) == pytest.approx(38.0)
    # a step with counters only (the dense oracle) has a wall and lanes, not phases
    run.spans.append(Span(-1, "decode_step", start_wall_s=4.0, end_wall_s=4.1, node_id=1,
                          attrs={"batch": 2, "lanes": 2, "context_tokens": 9}))
    assert phases.phases(run.spans[-1]) is None
    assert _read("decode_step_p50_ms.qa", run) == pytest.approx(45.0)
    assert _read("decode_host_p50_ms.qa", run) == pytest.approx(38.0)
    assert _read("decode_pad_pct.qa", run) == pytest.approx(100 * 4 / 30)


def test_a_program_without_the_spans_stamps_gives_nothing():
    run = _slice_run()
    chunk = run.spans[-1]
    for k in ("t_upload", "t_launch", "t_write"):
        del chunk.attrs[k]
    run.spans = [chunk]
    assert phases.host_intervals(run) == [] and phases.idle_by_phase(run) == {}
    assert all(_read(m, run) is None for m in METRICS)


def test_a_traced_rehearsal_reads_the_span_metrics(tmp_path):
    root = rehearsal.tiny_root(tmp_path)
    res = harness.execute("tiny.open", 2**31 + 27, 1.2, True, bench_root=root,
                          t_process=time.monotonic(), device="cpu")
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["decode_step_p50_ms.qa"] > got["decode_host_p50_ms.qa"] > 0
    assert 0 <= got["decode_pad_pct.qa"] < 100
    # no card, no device trace
    assert "launch_idle_pct.qa" not in got and "k3_roofline.qa" not in got
