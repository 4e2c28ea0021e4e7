"""``tests/test_sim.py``'s paper-trend cases that take the longest runs —
the heterogeneous fleet, distserve's saturation, colocated interference and
the role switch — on the port's simulator, each run's stats held equal to
the reference's (split from ``test_torch_sim.py``, whose helpers it uses, to
keep each file short on its worker)."""
import pytest

pytest.importorskip("torch")

from test_torch_sim import _one_thread, _sim, _stats  # noqa: E402,F401


def test_distserve_saturates_on_long_prompts():
    mid = _stats("distserve", rps=1.0)
    hi = _stats("distserve", rps=2.0)
    # saturation plateau: doubling RPS past saturation changes nothing
    assert abs(hi["throughput_tok_s"] - mid["throughput_tok_s"]) \
        < 0.2 * mid["throughput_tok_s"]
    fk = _stats("flowkv", rps=2.0)
    assert fk["throughput_tok_s"] > 1.4 * hi["throughput_tok_s"]


def test_colocated_tpot_degrades_under_long_prefill():
    colo = _stats("vllm_colocated", rps=1.0)
    disagg = _stats("flowkv", rps=1.0)
    assert colo["mean_tpot_s"] > disagg["mean_tpot_s"]


def test_heterogeneous_placement_gain():
    kw = dict(wl_name="gov_report", rps=0.5, seed=1, num_prefill=4, num_decode=4,
              same_host=False)
    g = _stats("flowkv", hw_prefill="l20", hw_decode="h20", **kw)
    b = _stats("flowkv", hw_prefill="h20", hw_decode="l20", **kw)
    assert g["mean_e2e_s"] < b["mean_e2e_s"], (g["mean_e2e_s"], b["mean_e2e_s"])


def test_role_switch_fires_under_imbalance():
    kw = dict(rps=2.0, num_prefill=1, num_decode=3)
    _stats("flowkv", **kw)
    events = [(e.cycle, e.kind, e.detail)
              for e in _sim("port", "flowkv", **kw)[0].controller.events]
    assert events == [(e.cycle, e.kind, e.detail)
                      for e in _sim("ref", "flowkv", **kw)[0].controller.events]
    kinds = {k for _, k, _ in events}
    assert "role_switch" in kinds or "regime" in kinds
