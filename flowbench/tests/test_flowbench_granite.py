"""granite-4.0-h-small's plain reference and its configuration file, on the
CPU at the port's smoke size (fp32):

* the reference's chunked SSD scan equals the token-by-token recurrence;
* the reference's logits equal the port's own forward, and the fp8 control
  moves them;
* the four expert shares of a layer (the port's ``moe_share_ffn`` on each
  share's experts), with the shared expert counted once, add up to the
  reference's uncut layer;
* ``harness.port_config`` builds the benchmark's file as the port's preset,
  and refuses a file whose counted keys differ from what the port builds.
"""
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from flowbench import flops, harness  # noqa: E402
from repro_torch.configs import granite_4_0_h_small as G4  # noqa: E402
from repro_torch.models import granite_hybrid as GH  # noqa: E402
from repro_torch.models import mlp as MLP  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402

REF = harness.load_module(ROOT / "flowbench" / "reference" / "granitemoehybrid.py",
                          "flowbench_reference_granitemoehybrid_test")
FILE = json.loads((ROOT / "flowbench" / "configs" / "granite-4.0-h-small.json").read_text())
SEED = 2**31 + 123


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILY = harness.load_module(ROOT / "flowbench" / "families" / "granitemoehybrid.py",
                             "flowbench_family_granitemoehybrid_test")
SMOKE = FAMILY.file_for(G4.smoke_config())


def test_the_chunked_scan_is_the_recurrence():
    # chunks of 8 over 29 tokens (the last one short) against the definition,
    # h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t; fp32, so
    # the two orders of summation agree to rounding (1e-5 of values ~1)
    g = torch.Generator().manual_seed(5)
    T, H, P, N = 29, 3, 4, 6
    x, B, C = (torch.randn(s, generator=g) for s in ((T, H, P), (T, N), (T, N)))
    dt = torch.rand((T, H), generator=g) + 0.05
    a = -torch.linspace(0.5, 4.0, H)
    h, want = torch.zeros(H, P, N), []
    for t in range(T):
        h = torch.exp(dt[t] * a)[:, None, None] * h + dt[t][:, None, None] * \
            x[t][..., None] * B[t][None, None]
        want.append(h @ C[t])
    want = torch.stack(want)
    for chunk in (8, 1, 64):
        assert torch.allclose(REF.ssd(x, dt, a, B, C, chunk), want, atol=1e-5, rtol=1e-5)


def test_the_reference_is_the_ports_forward_and_the_control_moves_it():
    mc = G4.smoke_config()
    params = REF.make_weights(SMOKE, SEED, "cpu")
    tokens = torch.randint(0, mc.vocab_size, (1, 50), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = GH.forward_train(params, mc, tokens)
    got = REF.logits_at(params, SMOKE, tokens[0].tolist(), range(50))
    # both fp32; the port sums its SSD and attention in other orders (K4's
    # plain version above flash_threshold 40): fp32 rounding of logits whose
    # size is ~1e-2
    assert torch.allclose(got, want[0], atol=2e-6, rtol=1e-5), float((got - want[0]).abs().max())
    ctrl = REF.logits_at(params, SMOKE, tokens[0].tolist(), range(50), quant="fp8")
    assert 1e-4 < float((ctrl - got).abs().max()) < 0.5 * float(got.abs().max())


def test_weights_follow_the_seed_and_the_ports_layout():
    a = REF.make_weights(SMOKE, 5, "cpu")
    b = REF.make_weights(SMOKE, 5, "cpu")
    c = REF.make_weights(SMOKE, 6, "cpu")
    want = GH.init_params(G4.smoke_config(), 0, "cpu")
    for group in ("layers", "mamba", "attn"):
        assert {k: v.shape for k, v in a[group].items()} == \
            {k: v.shape for k, v in want[group].items()}
        assert all(torch.equal(a[group][k], b[group][k]) for k in a[group])
    assert a["embed"].shape == want["embed"].shape and not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("tokens", [1, 23])
def test_the_four_expert_shares_add_up_to_the_uncut_layer(tokens):
    # 8 experts, 2 a share: the shares' parts (each the port's dense
    # dispatch over its own 2 experts) plus the shared expert once equal the
    # reference's layer over all 8 (fp32, sums in another order)
    mc = G4.smoke_config()
    full = dict(SMOKE, num_local_experts=mc.num_experts)
    lp = {k: v[1] for k, v in REF.make_weights(full, SEED, "cpu")["layers"].items()}
    y = torch.randn((1, tokens, mc.d_model), generator=torch.Generator().manual_seed(2))
    held = mc.moe_experts_held
    parts = sum(MOE.moe_share_ffn(
        {"router": lp["moe_router"], "w_gate": lp["moe_w_gate"][s:s + held],
         "w_up": lp["moe_w_up"][s:s + held], "w_down": lp["moe_w_down"][s:s + held]},
        y, mc, first=s) for s in range(0, mc.num_experts, held))
    shared = {k[len("shared_"):]: v for k, v in lp.items() if k.startswith("shared_")}
    with torch.no_grad():
        got = parts + MLP.gated_mlp(shared, y, "silu")
        want = REF.ffn(y[0], lp, mc.top_k)
    assert torch.allclose(got[0], want, atol=1e-6, rtol=1e-5)
    # one share alone is not the layer: the absent experts are left out
    one = REF.ffn(y[0], dict(lp, **{k: lp[k][:held] for k in ("moe_w_gate", "moe_w_up",
                                                                  "moe_w_down")}), mc.top_k)
    assert not torch.allclose(one, want, atol=1e-4)


def test_port_config_builds_the_benchmarks_file_as_the_preset():
    assert harness.port_config(FILE) == G4.config()
    assert harness.port_config(SMOKE) == G4.smoke_config()
    # the file counts the held experts: 10 a token of 18 held, the router at 18
    # outputs; flops.py's state and K/V bytes are the port's
    assert FILE["num_local_experts"] == 18 and FILE["published"]["num_local_experts"] == 72
    assert flops.state_bytes_per_request(FILE) == G4.config().state_slot_bytes() == 152_819_712
    assert flops.kv_bytes_per_token(FILE) == G4.config().kv_bytes_per_token() == 16_384


@pytest.mark.parametrize("change,key", [
    ({"num_local_experts": 72}, "num_local_experts"),
    ({"shared_intermediate_size": 768}, "shared_intermediate_size"),
    ({"layer_types": ["attention"] + FILE["layer_types"][1:]}, "layer_types"),
    ({"mamba_d_state": 64}, "mamba_d_state"),
    ({"head_dim": 64}, "head_dim"),
])
def test_a_file_counted_otherwise_than_the_port_builds_it_is_refused(change, key):
    with pytest.raises(ValueError, match=f"another model.*'{key}'"):
        harness.port_config(dict(FILE, **change))


def test_the_harness_serves_a_small_file_of_the_family_correct(tmp_path):
    # the tiny benchmark with a smoke-size granitemoehybrid file in a closed
    # cell: served through FlowKVClient, judged by this reference, and the
    # cell's span metrics read (the device's say nothing on the CPU)
    from flowbench import rehearsal
    root = rehearsal.tiny_root(tmp_path)
    fb = root / "flowbench"
    (fb / "configs" / "tiny-g4h.json").write_text(json.dumps(dict(SMOKE, name="tiny-g4h")))
    load = {"clients": 3, "num_blocks": 128, "max_batch_tokens": 32,
            "check": {"tokens": 40, "min_tokens": 10, "budget": 4000, "limit": 1e-3}}
    (fb / "cells" / "tiny-g4h.closed.json").write_text(json.dumps(load))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-g4h", "source": "test", "reduced": [], "why": "test",
                             "file": "flowbench/configs/tiny-g4h.json"})
    bench["workloads"].append({"name": "tiny-g4h.closed", "config": "tiny-g4h",
                               "traffic": "tiny-closed", "chips": 1, "why": "test"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "granite-4.0-h-small.lb-govreport" in m.get("workloads", []) or \
                "tiny.closed" in m.get("workloads", []):
            m["workloads"].append("tiny-g4h.closed")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    import time
    for trace in (False, True):
        res = harness.execute("tiny-g4h.closed", SEED, 1.2, trace, bench_root=root,
                              t_process=time.monotonic(), device="cpu")
        assert res["correct"] and res["failed"] == 0, res["checks"]
        assert res["checks"]["max_logit_gap"]["value"] <= 1e-4
    got = res["metrics"]
    assert got["decode_graph_pct.g4h"]["value"] == 0.0 and got["decode_step_p50_ms.g4h"]["value"] > 0
    assert not {"decode_bw_pct.g4h", "mfu.g4h", "k3_roofline.g4h", "device_idle_pct.g4h"} & set(got)
