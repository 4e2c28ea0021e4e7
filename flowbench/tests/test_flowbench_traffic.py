"""The traffic generator: deterministic by seed, the same multiset of sizes
for every seed, and the stated distributions."""
import json
import math
import pathlib
import statistics
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from flowbench import traffic  # noqa: E402

MIXES = ROOT / "flowbench" / "traffic"
QA = json.loads((MIXES / "lb-qa.json").read_text())
# the paper's gov_report profile as the port's sim/workload.py LONGBENCH states it,
# in a closed loop
GOV = json.loads((MIXES / "lb-govreport.json").read_text())
BIG = 2**31 + 12345


def test_open_loop_is_deterministic_by_seed():
    a = traffic.OpenLoop(QA, {"rate": 2.0}, BIG, 51, 151936)
    b = traffic.OpenLoop(QA, {"rate": 2.0}, BIG, 51, 151936)
    assert [(r.prompt, r.max_new, r.due) for r in a.window] == \
        [(r.prompt, r.max_new, r.due) for r in b.window]
    assert [r.prompt for r in a.preroll] == [r.prompt for r in b.preroll]


def test_lb_qa_offers_every_seed_one_schedule_and_other_tokens():
    a = traffic.OpenLoop(QA, {"rate": 2.0}, 7, 51, 1000)
    b = traffic.OpenLoop(QA, {"rate": 2.0}, BIG, 51, 1000)
    assert [(r.prompt_len, r.max_new, r.due) for r in a.window] == \
        [(r.prompt_len, r.max_new, r.due) for r in b.window]
    assert a.window[0].prompt != b.window[0].prompt
    unfixed = dict(QA)
    del unfixed["schedule_seed"]
    c = traffic.OpenLoop(unfixed, {"rate": 2.0}, 7, 51, 1000)
    assert sorted(r.prompt_len for r in c.window) == sorted(r.prompt_len for r in a.window)
    assert [r.prompt_len for r in c.window] != [r.prompt_len for r in a.window]


def _unfixed(mix):
    return {k: v for k, v in mix.items() if k != "schedule_seed"}


@pytest.mark.parametrize("mix,load", [(_unfixed(QA), {"rate": 2.0}),
                                      (_unfixed(GOV), {"clients": 26})])
def test_seeds_share_sizes_in_another_order(mix, load):
    def sizes(seed):
        if mix["loop"] == "open":
            g = traffic.OpenLoop(mix, load, seed, 51, 1000)
            return [(r.prompt_len, r.max_new) for r in g.window]
        g = traffic.ClosedLoop(mix, load, seed, 1000)
        # every round of `clients` requests holds the same sizes
        return list(zip(g.plens.tolist(), g.olens.tolist()))[:load["clients"]]
    a, b = sizes(7), sizes(BIG)
    assert sorted(x for x, _ in a) == sorted(x for x, _ in b)
    assert sorted(y for _, y in a) == sorted(y for _, y in b)
    assert a != b


def test_lb_govreport_offers_every_seed_one_schedule_and_other_tokens():
    a = traffic.ClosedLoop(GOV, {"clients": 24}, 7, 1000)
    b = traffic.ClosedLoop(GOV, {"clients": 24}, BIG, 1000)
    assert a.plens.tolist() == b.plens.tolist() and a.olens.tolist() == b.olens.tolist()
    assert a.first_u.tolist() == b.first_u.tolist()
    ra, rb = a.next_request(0, first=True), b.next_request(0, first=True)
    assert (ra.prompt_len, ra.max_new) == (rb.prompt_len, rb.max_new)
    assert ra.prompt != rb.prompt
    c = traffic.ClosedLoop(_unfixed(GOV), {"clients": 24}, 7, 1000)
    assert sorted(c.plens[:24].tolist()) == sorted(a.plens[:24].tolist())
    assert c.plens.tolist() != a.plens.tolist()


def test_lb_qa_lengths_and_arrivals():
    g = traffic.OpenLoop(QA, {"rate": 2.0}, 3, 51, 151936)
    assert len(g.window) == 102 and len(g.preroll) == 16
    plens = [r.prompt_len for r in g.window]
    assert min(plens) >= 1024 and 16000 <= max(plens) <= 16384
    # in rounds of 10: each round holds one size of each decile
    assert sorted(plens[:10]) == sorted(plens[10:20])
    assert abs(statistics.median(plens[:100]) - 6000) <= 60
    outs = [r.max_new for r in g.window]
    assert min(outs) >= 16 and max(outs) <= 128
    assert abs(statistics.mean(outs) - 72) < 2
    dues = [r.due for r in g.window]
    assert dues[0] == 0.0 and all(b > a for a, b in zip(dues, dues[1:])) and dues[-1] < 51
    gaps = np.diff(dues + [51.0])
    assert math.isclose(gaps.sum(), 51.0)
    # exponential gaps: mean 1/rate, coefficient of variation ~1
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.15
    assert all(0 <= t < 151936 for r in g.window[:5] for t in r.prompt)
    assert all(-8 <= r.due < 0 for r in g.preroll)


def test_lb_govreport_lengths_and_first_outputs():
    g = traffic.ClosedLoop(GOV, {"clients": 26}, 5, 151936)
    assert abs(g.plens.mean() - 8734) < 30 and abs(g.plens.std() - 3000) < 200
    assert sorted(g.plens[:26]) == sorted(g.plens[26:52])
    assert abs(g.plens[:26].mean() - 8734) < 30
    assert g.plens.min() >= 16 and abs(g.olens.mean() - 512) < 5
    firsts = [g.next_request(c, first=True) for c in range(26)]
    drawn = g.olens[:26]
    assert all(1 <= r.max_new <= d for r, d in zip(firsts, drawn))
    # uniform below the drawn length: the shares spread over (0, 1)
    shares = sorted(r.max_new / d for r, d in zip(firsts, drawn))
    assert shares[0] < 0.1 and shares[-1] > 0.9
    nxt = g.next_request(3, first=False)
    assert nxt.index == 26 and nxt.max_new == g.olens[26] and nxt.prompt_len == g.plens[26]


@pytest.mark.parametrize("spec,u,want", [
    ({"dist": "lognormal", "median": 6000, "sigma": 0.6}, 0.5, 6000.0),
    ({"dist": "normal", "mean": 8734, "std": 3000, "min": 16}, 0.5, 8734.0),
    ({"dist": "normal", "mean": 10, "std": 3000, "min": 16}, 0.01, 16.0),
    ({"dist": "uniform", "min": 16, "max": 128}, 0.5, 72.5),
    ({"dist": "exponential", "mean": 0.5}, 1 - math.exp(-1), 0.5),
])
def test_quantiles(spec, u, want):
    assert math.isclose(traffic.quantile(spec, u), want, rel_tol=1e-9)
