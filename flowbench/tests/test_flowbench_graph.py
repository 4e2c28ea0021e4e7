"""``decode_graph_pct.qa``: the share of the window's ``decode_step`` spans
that the engine served by replaying a CUDA graph, on a synthetic window
against values worked out by hand; a program whose spans carry no ``graph``
attr gives nothing; a traced rehearsal on the CPU reads 0 (a CPU engine
replays no graph)."""
import json
import pathlib
import sys
import time
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from flowbench import harness, rehearsal  # noqa: E402
from repro_torch.obs.tracing import Span  # noqa: E402

CFG = json.loads((ROOT / "flowbench" / "configs" / "qwen3-1.7b.json").read_text())
METRIC = "decode_graph_pct.qa"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(run):
    return harness.load_module(ROOT / "flowbench" / "metrics" / f"{METRIC}.py", METRIC).read(run)


def _step(t, **attrs):
    return Span(-1, "decode_step", start_wall_s=t, end_wall_s=t + 0.02, node_id=1,
                attrs={"batch": 3, "lanes": 4, "context_tokens": 100, **attrs})


def _window(hows):
    """The window [0, 12] s with the profiler from 10 s: a step before the
    window, one after the profiler's start, and a step a second from 1 s
    that ran as ``hows`` says (None: no attr)."""
    run = harness.Run(cell=types.SimpleNamespace(cfg=CFG, mix={"loop": "open"}), peak=None)
    run.t_start, run.t_end, run.traced_from = 0.0, 12.0, 10.0
    run.spans = [_step(-1.0, graph="eager"), _step(10.5, graph="eager")]
    run.spans += [_step(1.0 + i) if how is None else _step(1.0 + i, graph=how)
                  for i, how in enumerate(hows)]
    return run


def test_decode_graph_pct_on_a_synthetic_window():
    # the steps outside the window (both eager) count for nothing
    assert _read(_window(["capture", "replay", "replay", "replay"])) == pytest.approx(75.0)
    assert _read(_window(["replay"] * 5)) == pytest.approx(100.0)
    assert _read(_window(["capture", "eager", "replay", "eager", "replay"])) == \
        pytest.approx(40.0)
    assert _read(_window(["eager", "eager"])) == 0.0
    # a step without the attr is left out; one prefill chunk is no step
    run = _window(["replay", None, "capture"])
    run.spans.append(Span(4, "prefill_chunk", start_wall_s=2.5, end_wall_s=2.6, node_id=0,
                          attrs={"offset": 0, "tokens": 64, "prompt_len": 64,
                                 "final": True}))
    assert _read(run) == pytest.approx(50.0)


def test_a_program_without_the_attr_gives_nothing():
    run = _window([None, None, None])
    run.spans = run.spans[2:]
    assert _read(run) is None
    run.spans = []
    assert _read(run) is None


def test_a_traced_rehearsal_reads_no_replay_on_the_cpu(tmp_path):
    root = rehearsal.tiny_root(tmp_path)
    res = harness.execute("tiny.open", 2**31 + 43, 1.2, True, bench_root=root,
                          t_process=time.monotonic(), device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"][METRIC]["value"] == 0.0
