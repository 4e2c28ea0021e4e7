"""The port's state transfer path under faults, against the reference:
mamba2-370m and recurrentgemma-2b smoke served 1P+1D (1P+2D for the
crash) by both packages' ``PDCluster`` on the reference's weights, with the
same seeded fault (helpers from ``test_torch_state_serving.py``).

Bars: under a ``transfer_fail`` (once, and on every attempt, which
degrades the request to recompute), a ``transfer_corrupt`` (not verifiable
on the state path, so it acts as a drop) and a decode ``node_crash``, the
fault counters, recoveries, tokens (also against the port's monolithic
generation) and transfer records equal the reference's, and no block
leaks. No state is left behind in the port; the reference keeps a
degraded request's state on its source node for good.
"""
import pytest

torch = pytest.importorskip("torch")

from repro import faults as RF  # noqa: E402
from repro_torch import faults as F  # noqa: E402
from test_torch_state_serving import (ARCHS, _cluster, _monolithic, _one_thread,  # noqa: E402,F401
                                      _outs, _prompts, _records, _request, _weights)

COUNTERS = ("fault_kills", "transfer_retries", "degraded_to_recompute", "recoveries",
            "finished")


FAULTS = {
    "transfer_fail": ([("transfer_fail", dict(at=0.0, count=1))], 1),
    "transfer_fail_exhausted": ([("transfer_fail", dict(at=0.0, count=4))], 1),
    "transfer_corrupt": ([("transfer_corrupt", dict(at=0.0, count=1))], 1),
    "node_crash": ([("node_crash", dict(at=2.0, node_id=1))], 2),    # mid-decode
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_faults_equal_reference(arch, fault):
    """The same seeded fault in both packages: counters, recoveries, tokens
    and transfer records equal the reference's; a corrupt attempt on the
    state path is not verifiable, so it is a drop. Four failed attempts
    degrade the request to recompute."""
    specs, num_decode = FAULTS[fault]
    cfg = _weights(arch)[2]
    prompts = _prompts(cfg.vocab_size)
    runs = {}
    for port in (True, False):
        pkg = F if port else RF
        cluster = _cluster(port, arch, num_decode=num_decode, heartbeat_timeout_cycles=2.0,
                           faults=[pkg.FaultSpec(kind, **kw) for kind, kw in specs])
        cluster.run([_request(port, p) for p in prompts], max_cycles=300)
        runs[port] = cluster
    port, ref = runs[True], runs[False]
    ps, rs = port.stats(), ref.stats()
    assert {k: ps[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    assert ps["finished"] == len(prompts)
    assert ps["fault_kills"] + ps["transfer_retries"] > 0, "the fault never fired"
    assert _outs(port) == _outs(ref) == {tuple(p): _monolithic(arch, p) for p in prompts}
    assert _records(port) == _records(ref)
    # a degraded request's state stays on the reference's source node for
    # good; the port drops it with the request's blocks
    assert all(not e.states for e in port.engines.values())
    left = sorted(rid for e in ref.engines.values() for rid in e.states)
    assert len(left) == rs["degraded_to_recompute"]
    assert ps["leaked_blocks"] == rs["leaked_blocks"] == 0.0
