"""Runs of the harness on the CPU at a tiny size (``flowbench.rehearsal``):
the served path judged correct, the result's metrics, faults planted under
the timed path coming out not correct, the control failing its limit, new
cells, mixes and metrics found by name, no JAX or JAX package loaded, and the
command refusing to run without a card or without the program."""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from flowbench import harness, rehearsal  # noqa: E402
import repro_torch.kernels.kv_gather as kv_gather_pkg  # noqa: E402
import repro_torch.serving.cluster as cluster_mod  # noqa: E402

SEED = 2**31 + 99


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return rehearsal.tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(tiny, cell, trace=False, seconds=1.2, **kw):
    return harness.execute(cell, SEED, seconds, trace, bench_root=tiny,
                           t_process=time.monotonic(), device="cpu", **kw)


@pytest.mark.parametrize("cell", ["tiny.open", "tiny.closed", "tiny-moe.open"])
def test_the_served_path_is_judged_correct(tiny, cell):
    res = _run(tiny, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {"ttft_p50_s", "ttft_p90_s", "itl_p90_ms", "setup_s"} if cell.endswith("open") \
        else {"itl_p90_ms", "setup_s", "output_tok_s", "itl_p90_ms.gov"}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["checks"]["max_logit_gap"]["value"] <= 1e-4
    assert res["checks"]["mean_logit_gap"]["value"] <= 1e-5
    assert res["checks"]["tokens_compared"]["value"] >= 10
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}


def test_a_traced_closed_run_reads_the_gov_span_metrics(tiny):
    res = _run(tiny, "tiny.closed", trace=True)
    assert res["correct"], res["checks"]
    got = {k: m["value"] for k, m in res["metrics"].items()}
    assert {"decode_step_p50_ms.gov", "decode_host_p50_ms.gov", "decode_pad_pct.gov",
            "decode_graph_pct.gov"} <= set(got)
    assert 0 < got["decode_host_p50_ms.gov"] <= got["decode_step_p50_ms.gov"]
    # a CPU engine steps eagerly: no step replays a graph
    assert got["decode_graph_pct.gov"] == 0.0
    # no card, no device trace: the device's metrics say nothing
    assert not {"launch_idle_pct.gov", "mfu.gov", "k3_roofline.gov",
                "device_idle_pct.gov"} & set(got)


def test_the_reference_runs_after_the_programs_state_is_freed(tiny, monkeypatch):
    import gc
    from flowbench import check
    from repro_torch.serving.kv_cache import PagedKVCache
    judge, live = check.judge, []

    def counting(*a, **kw):
        live.append(sum(type(o) is PagedKVCache for o in gc.get_objects()))
        return judge(*a, **kw)
    monkeypatch.setattr(check, "judge", counting)
    assert _run(tiny, "tiny.closed", trace=True)["correct"]
    assert live == [0]


def _decode_node(client):
    return client.cluster.engines[1]


def _alter_token(client):
    """A token altered where it is produced: every decoded token + 1."""
    eng = _decode_node(client)
    step = eng._decode_paged_kernel

    def bad(batch):
        n = step(batch)
        for r in batch:
            r.output_tokens[-1] = (r.output_tokens[-1] + 1) % eng.cfg.vocab_size
        return n
    eng._decode_paged_kernel = bad


def _half_batch(client):
    """Half of the batch left out: its lanes take the other half's logits."""
    import dataclasses
    eng = _decode_node(client)
    step = eng.model.decode_paged

    def bad(params, tok, pool, bt, lens):
        logits, pool = step(params, tok, pool, bt, lens)
        b = logits.shape[0]
        logits = logits.clone()
        logits[(b + 1) // 2:] = logits[:b // 2]
        return logits, pool
    eng.model = dataclasses.replace(eng.model, decode_paged=bad)


@pytest.mark.parametrize("cell", ["tiny.open", "tiny-moe.open", "tiny.closed"])
@pytest.mark.parametrize("fault", ["alter_token", "half_batch", "stale_state", "no_transfer"])
def test_a_fault_under_the_timed_path_is_not_correct(tiny, monkeypatch, fault, cell):
    plant = None
    if fault == "alter_token":
        plant = _alter_token
    elif fault == "half_batch":
        plant = _half_batch
    elif fault == "stale_state":
        # the decode step returns the pool as it found it: no K/V appended
        monkeypatch.setattr(kv_gather_pkg, "kv_append_tokens", lambda *a, **k: None)
    else:
        # the P -> D exchange left out, and its verify told all is well
        def plant(client):
            _decode_node(client).kv.import_plan = lambda *a, **k: None
        monkeypatch.setattr(cluster_mod, "verify_pool_transfer", lambda *a, **k: True)
    res = _run(tiny, cell, plant=plant)
    assert not res["correct"]
    judged = [c for c in res["checks"].values() if "limit" in c and not c.get("at_least")
              and c["limit"] > 0]
    assert len(judged) == 1 and judged[0]["value"] > judged[0]["limit"]


@pytest.mark.parametrize("cell", ["tiny.open", "tiny.closed"])
def test_the_control_in_the_programs_place_is_not_correct(tiny, cell):
    from flowbench import check
    res = _run(tiny, cell, control=True)
    assert res["correct"], res["checks"]
    ctrl = res["control"]
    assert not ctrl["correct"] and not check.passed(ctrl["checks"])
    # judged by the same numbers and limits as the program, failing the widest gap
    assert {k: c.get("limit") for k, c in ctrl["checks"].items()} == \
        {k: c.get("limit") for k, c in res["checks"].items() if k in ctrl["checks"]}
    gap = ctrl["checks"]["max_logit_gap"]
    assert gap["value"] > 3 * gap["limit"]
    assert ctrl["checks"]["tokens_compared"] == res["checks"]["tokens_compared"]


def test_new_cells_mixes_and_metrics_are_found_by_name(tmp_path):
    root = rehearsal.tiny_root(tmp_path)
    fb = root / "flowbench"
    cfg = json.loads((fb / "configs" / "tiny.json").read_text())
    (fb / "configs" / "tiny-wide.json").write_text(json.dumps(dict(cfg, name="tiny-wide",
                                                                   hidden_size=96)))
    mix = json.loads((fb / "traffic" / "tiny-open.json").read_text())
    mix["output_len"] = {"dist": "uniform", "min": 2, "max": 4}
    (fb / "traffic" / "tiny-short.json").write_text(json.dumps(mix))
    load = json.loads((fb / "cells" / "tiny.open.json").read_text())
    (fb / "cells" / "tiny-wide.short.json").write_text(json.dumps(load))
    (fb / "metrics" / "prompt_tokens.short.py").write_text(
        "def read(run):\n    return float(sum(r.prompt_len for r in run.window_reqs()))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-wide", "source": "test", "reduced": [],
                             "why": "test", "file": "flowbench/configs/tiny-wide.json"})
    bench["workloads"].append({"name": "tiny-wide.short", "config": "tiny-wide",
                               "traffic": "tiny-short", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "prompt_tokens.short", "unit": "tokens",
                               "better": "higher", "source": "host_clock", "layer": "client",
                               "moves": "ttft_p90_s", "workloads": ["tiny-wide.short"]})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "tiny.open" in m.get("workloads", []):
            m["workloads"].append("tiny-wide.short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("tiny-wide.short", root)
    assert cell.cfg["hidden_size"] == 96 and cell.mix["output_len"]["max"] == 4
    res = _run(root, "tiny-wide.short", trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["prompt_tokens.short"]["value"] > 0
    assert {"queue_wait_p90_s.qa", "transfer_p50_ms.qa", "prefill_phase_p50_ms.qa"} <= set(got)
    # no card, no device trace: the device's metrics say nothing
    assert not {"mfu.qa", "k4_roofline.qa", "device_idle_pct.qa"} & set(got)
    assert "breakdown" not in res


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BENCH_RUN")}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_a_rehearsal_loads_no_jax_and_no_jax_package(tmp_path):
    code = f"""
import sys, time, pathlib
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
torch.set_num_threads(1)
from flowbench import harness, rehearsal, run
root = rehearsal.tiny_root(pathlib.Path({str(tmp_path)!r}))
res = harness.execute("tiny.open", 5, 0.6, True, bench_root=root,
                      t_process=time.monotonic(), device="cpu")
print(res["correct"], run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_clean_env(), timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def test_the_command_needs_a_card_and_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run([sys.executable, "flowbench/run.py", "--workload", "qwen3-1.7b.lb-qa",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, env=_clean_env(),
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr


def test_the_command_needs_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "flowbench", tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "flowbench/run.py", "--workload", "qwen3-1.7b.lb-qa",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, env=_clean_env(),
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")


def _program_and_control_on_the_card(workload: str, seconds: int) -> None:
    out = subprocess.run([sys.executable, "flowbench/calibrate.py", "--workload", workload,
                          "--seconds", str(seconds), "--seeds", str(SEED),
                          "--control", str(SEED)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and not res["control_correct"], res


@pytest.mark.gpu
def test_the_control_is_not_correct_at_the_cells_load_on_the_card(card):
    _program_and_control_on_the_card("qwen3-1.7b.lb-qa", 20)


@pytest.mark.gpu
def test_the_control_is_not_correct_at_the_govreport_load_on_the_card(card):
    _program_and_control_on_the_card("qwen3-1.7b.lb-govreport", 30)


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "flowbench/run.py", "--workload", "qwen3-1.7b.lb-qa",
                          "--seed", str(SEED), "--seconds", "8", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
