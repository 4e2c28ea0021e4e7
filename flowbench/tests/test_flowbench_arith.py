"""The benchmark's arithmetic on synthetic records, against values worked
out by hand: percentiles, the drain and the latencies a client
sees, the device-busy union and idle gaps, and the closed-form work, MFU
and rooflines of both configurations."""
import json
import math
import pathlib
import sys
import types

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from flowbench import devtrace, flops, harness, readers, stats, traffic  # noqa: E402

# granite-moe-1b-a400m at its published widths (hf:ibm-granite/granite-3.0-1b-a400m-base):
# the MoE case of the closed-form work, which no cell runs yet
GRANITE = {"name": "granite-moe-1b-a400m", "hidden_size": 1024, "intermediate_size": 512,
           "num_hidden_layers": 24, "num_attention_heads": 16, "num_key_value_heads": 8,
           "head_dim": 64, "num_local_experts": 32, "num_experts_per_tok": 8,
           "vocab_size": 49155, "tie_word_embeddings": True, "qk_norm": False,
           "ffn": "moe_topk", "dtype": "bfloat16", "block_size": 32, "flash_threshold": 1024}
CFG = {"qwen3-1.7b": json.loads((ROOT / "flowbench" / "configs" / "qwen3-1.7b.json").read_text()),
       "granite-moe-1b-a400m": GRANITE}
H100 = flops.peaks("NVIDIA H100 80GB HBM3")


def test_percentile():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0]
    for p in (0, 10, 50, 90, 95, 100):
        assert math.isclose(stats.percentile(xs, p), float(np.percentile(xs, p)))
    with pytest.raises(ValueError):
        stats.percentile([], 50)


@pytest.mark.parametrize("name,layer,kv_bytes,head", [
    # qwen: attention 2*2048*2048 + 2*2048*1024, MLP 3*2048*6144
    ("qwen3-1.7b", 12_582_912 + 37_748_736, 114_688, 2 * 2048 * 151936),
    # granite: attention 2*1024*1024 + 2*1024*512, router 1024*32, top-8 of
    # 32 experts of 3*1024*512 (the dense dispatch's 32 do not count)
    ("granite-moe-1b-a400m", 3_145_728 + 32_768 + 8 * 1_572_864, 49_152, 2 * 1024 * 49155),
])
def test_closed_form_work(name, layer, kv_bytes, head):
    cfg = CFG[name]
    L = cfg["num_hidden_layers"]
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    assert flops.layer_params_active(cfg) == layer
    assert flops.kv_bytes_per_token(cfg) == kv_bytes
    assert flops.head_flops(cfg) == head
    pair = 4 * L * 16 * hd
    # a chunk of 2048 after 4096 resident tokens, not the last
    want = 2 * L * layer * 2048 + pair * (2048 * 4096 + 2048 * 2049 / 2)
    assert math.isclose(flops.chunk_flops(cfg, 4096, 2048, False), want)
    assert math.isclose(flops.chunk_flops(cfg, 4096, 2048, True), want + head)
    assert math.isclose(flops.decode_flops(cfg, 9000), 2 * L * layer + pair * 9001 + head)
    # K4 takes a chunk only above flash_threshold
    assert flops.k4_chunk_cost(cfg, 0, 1024) is None
    k4 = flops.k4_chunk_cost(cfg, 1024, 32)
    assert k4["flops"] == pair * (32 * 1024 + 32 * 33 / 2)
    assert k4["bytes"] == L * 2 * hd * (2 * 32 * 16 + 2 * 1056 * 8)


def test_roofline_takes_the_larger_bound():
    cost = {"flops": 989e12 * 0.002, "bytes": 3.35e12 * 0.001}     # 2 ms vs 1 ms
    assert math.isclose(flops.roofline_pct(cost, 0.004, H100, "bfloat16"), 50.0)
    cost = {"flops": 1.0, "bytes": 3.35e12 * 0.003}
    assert math.isclose(flops.roofline_pct(cost, 0.004, H100, "bfloat16"), 75.0)


def test_device_union_and_idle_gaps():
    recs = [("k4", 100, 200), ("gemm", 150, 300), ("k3", 400, 450), ("copy", 440, 500),
            ("k3", 900, 1000)]
    assert devtrace.union([(s, e) for _, s, e in recs]) == [(100, 300), (400, 500), (900, 1000)]
    assert devtrace.busy_ns(recs, 0, 1000) == 400
    assert devtrace.busy_ns(recs, 120, 950) == 180 + 100 + 50
    assert devtrace.by_name(recs, "k3") == {"k3": 150e-9}
    host = [("decode", 0, 80), ("prefill", 300, 350), ("transfer", 600, 700)]
    gaps = devtrace.idle_gaps(recs, 0, 1000, host)
    # idle: [0,100) [300,400) [500,900): decode 80, prefill 50, transfer 100, rest harness
    assert gaps == pytest.approx({"decode": 80e-9, "prefill": 50e-9, "transfer": 100e-9,
                                  "harness": 370e-9})
    assert math.isclose(sum(gaps.values()), 600e-9)


def _run(cfg_name, loop="open"):
    cell = types.SimpleNamespace(cfg=CFG[cfg_name], mix={"loop": loop})
    return harness.Run(cell=cell, peak=H100)


def _req(i, due, first, tokens, in_window=True, prompt=10):
    r = traffic.Req(index=i, prompt=[0] * prompt, max_new=len(tokens), in_window=in_window)
    r.due_at, r.first_t, r.token_t = due, first, list(tokens)
    r.rid = i
    return r


def test_latencies_a_client_sees():
    run = _run("qwen3-1.7b")
    run.t_start, run.t_end = 100.0, 110.0
    run.reqs = [
        _req(0, 98.0, 100.5, [100.5, 100.6, 100.8], in_window=False),   # pre-roll
        _req(1, 101.0, 101.5, [101.5, 101.5, 101.7, 102.0]),
        _req(2, 109.0, 111.0, [111.0, 111.1]),       # drained after the close
        _req(3, 105.0, 106.0, [106.0, 109.9, 110.3]),
    ]
    # every request sent in the window, timed from when it was due
    assert sorted(readers.ttfts(run)) == pytest.approx([0.5, 1.0, 2.0])
    # gaps whose later token came in (t_start, t_end]; the pre-roll's count
    assert sorted(readers.itl_gaps(run)) == pytest.approx(sorted([0.1, 0.2, 0.0, 0.2, 0.3, 3.9]))
    mods = {m: harness.load_module(ROOT / "flowbench" / "metrics" / f"{m}.py", m)
            for m in ("ttft_p50_s", "ttft_p90_s", "itl_p90_ms", "output_tok_s")}
    assert mods["ttft_p50_s"].read(run) == pytest.approx(1.0)
    assert mods["ttft_p90_s"].read(run) == pytest.approx(1.8)
    assert mods["itl_p90_ms"].read(run) == pytest.approx(1000 * float(np.percentile(
        [0.1, 0.2, 0.0, 0.2, 0.3, 3.9], 90)))
    # tokens stamped in (t_start, t_end]: 3 + 4 + 0 + 2, over the 10 s window
    assert mods["output_tok_s"].read(run) == pytest.approx(0.9)


@pytest.mark.parametrize("cfg_name", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_mfu_rooflines_and_idle_on_a_synthetic_slice(cfg_name):
    cfg = CFG[cfg_name]
    run = _run(cfg_name)
    run.slice_mono, run.slice_ns = (10.0, 12.0), (5_000_000_000, 7_000_000_000)
    span = lambda t, attrs: types.SimpleNamespace(name="prefill_chunk", start_wall_s=t,
                                                   attrs=attrs)
    run.spans = [span(9.0, {"offset": 0, "tokens": 2048, "final": False}),       # before
                 span(10.5, {"offset": 2048, "tokens": 2048, "final": False}),
                 span(11.5, {"offset": 4096, "tokens": 904, "final": True})]
    run.steps = [harness.Step(9.9, 10.2, [5000]),                  # starts before
                 harness.Step(10.2, 10.4, [5000, 7000]),
                 harness.Step(11.8, 11.95, [3000])]
    run.device_records = [("flash_prefill_mma_kernel", 5_100_000_000, 5_150_000_000),
                          ("paged_decode_split_kernel", 5_200_000_000, 5_210_000_000),
                          ("gemm", 5_140_000_000, 5_600_000_000)]
    work = (flops.chunk_flops(cfg, 2048, 2048, False) + flops.chunk_flops(cfg, 4096, 904, True)
            + flops.decode_flops(cfg, 5000) + flops.decode_flops(cfg, 7000)
            + flops.decode_flops(cfg, 3000))
    assert readers.mfu(run) == pytest.approx(100 * work / (2.0 * 989e12))
    k4 = harness.load_module(ROOT / "flowbench" / "metrics" / "k4_roofline.qa.py", "k4").read
    attn = flops.attn_pair_flops(cfg) * (flops.causal_pairs(2048, 2048)
                                         + flops.causal_pairs(4096, 904))
    assert k4(run) == pytest.approx(100 * attn / 989e12 / 0.05)
    assert readers.idle_pct(run) == pytest.approx(100 * (1 - 0.5 / 2.0))
    run.device_records = []
    assert readers.mfu(run) is None and readers.idle_pct(run) is None and k4(run) is None
