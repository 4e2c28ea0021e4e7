"""The port's serving checkpoint on the CPU, against the reference: the
round trips of ``tests/test_cluster.py:91``, ``tests/test_api.py:197`` and
``:216`` and ``tests/test_prefix_reuse.py:257``, on the qwen3-1.7b smoke
config with the reference's weights bridged, and checkpoints crossing the
packages: one written by the reference's ``save_cluster`` loads into a port
cluster and finishes, and one the port writes loads into the reference.

Bars: a checkpoint taken mid-flight and restored into a fresh port cluster
finishes with the greedy reference's tokens and no leaks, with either
allocator; roles, ``home_role``, priority, cancelled, rejected and spilled
K/V survive; a restore onto a used cluster resets its block state; across
the packages the tokens and every node's block tables, step by step, equal
those of the writer's package finishing its own restore.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving import checkpoint as RCK  # noqa: E402
from repro.serving.cluster import PDCluster as RefCluster  # noqa: E402
from repro.serving.request import Request as RefRequest  # noqa: E402
from repro.serving.request import SamplingParams as RefSampling  # noqa: E402
from repro.sim.hardware import TPU_V5E as REF_V5E  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.scheduler import AdmissionPolicy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.bridge import from_reference  # noqa: E402
from repro_torch.serving import checkpoint as CK  # noqa: E402
from repro_torch.serving.api import FlowKVClient  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.request import Request, RequestState, SamplingParams  # noqa: E402
from repro_torch.sim.hardware import TPU_V5E  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_smoke("qwen3-1.7b")
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("qwen3-1.7b")
    params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return rcfg, rparams, cfg, params


def _cluster(weights, **kw):
    _, _, cfg, params = weights
    return PDCluster(cfg, params, device="cpu", **kw)


def _request(prompt, steps):
    return Request(prompt_tokens=list(prompt), sampling=SamplingParams(max_new_tokens=steps))


def _prompts(vocab, n=3, seed=7):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=rng.randint(5, 30)))) for _ in range(n)]


def _greedy(weights, prompts, steps):
    _, _, cfg, params = weights
    return {tuple(p): T.greedy_generate(params, cfg, torch.tensor([p], dtype=torch.int32),
                                        steps)[0].tolist() for p in prompts}


def _finish(cluster, n, max_cycles=80):
    for _ in range(max_cycles):
        if len(cluster.finished) >= n:
            return
        cluster.step()
    raise AssertionError(f"{len(cluster.finished)} of {n} finished")


def _outs(cluster):
    return {tuple(map(int, r.prompt_tokens)): list(map(int, r.output_tokens))
            for r in cluster.finished}


@pytest.mark.parametrize("allocator", ["flowkv", "freelist"])
def test_cluster_checkpoint_roundtrip(tmp_path, weights, allocator):
    """Saved mid-flight, restored into a fresh cluster, finished: the greedy
    reference's tokens, no leaks, the allocator's invariants intact."""
    prompts = _prompts(weights[2].vocab_size)
    cluster = _cluster(weights, num_prefill=1, num_decode=1, num_blocks=64,
                       allocator=allocator)
    for p in prompts:
        cluster.submit(_request(p, 6))
    for _ in range(3):                        # mid-flight
        cluster.step()
    state = cluster.checkpoint()
    assert set(state) == {"clock", "nodes", "finished", "cancelled", "rejected"}
    busy = sum(len(q) for n in state["nodes"].values() for q in n["queues"].values())
    assert busy > 0, "nothing was in flight at the checkpoint"
    CK.save_cluster(cluster, str(tmp_path / "ckpt"))

    c2 = _cluster(weights, num_prefill=1, num_decode=1, num_blocks=64, allocator=allocator)
    CK.load_cluster(c2, str(tmp_path / "ckpt"))
    for nid, eng in c2.engines.items():       # the pools came back bit for bit
        assert torch.equal(eng.kv.pool, cluster.engines[nid].kv.pool)
        eng.scheduler.bm.check_invariants()
    _finish(c2, len(prompts))
    assert _outs(c2) == _greedy(weights, prompts, 6)
    assert c2.audit_blocks() == 0
    c2.assert_no_leaks()
    for eng in c2.engines.values():
        eng.scheduler.bm.check_invariants()
        assert eng.scheduler.bm.free_capacity == 64


def test_checkpoint_restores_roles_and_cancelled(tmp_path, weights):
    _, _, cfg, params = weights
    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=2, num_blocks=64, device="cpu")
    client.set_role(2, "prefill")
    client.controller.nodes[2].home_role = "decode"
    h = client.submit(list(range(8)), SamplingParams(max_new_tokens=4))
    assert h.cancel()
    CK.save_cluster(client.cluster, str(tmp_path / "ckpt"))

    c2 = _cluster(weights, num_prefill=1, num_decode=2, num_blocks=64)
    CK.load_cluster(c2, str(tmp_path / "ckpt"))
    assert c2.controller.nodes[2].role == "prefill"          # flip survives
    assert c2.controller.nodes[2].home_role == "decode"      # flip-back armed
    assert c2.engines[2].scheduler.priority == "prefill"
    assert len(c2.cancelled) == 1
    assert c2.cancelled[0].state is RequestState.CANCELLED
    assert c2.audit_blocks() == 0


def test_checkpoint_roundtrips_rejected_and_spilled(tmp_path, weights):
    """A checkpoint taken mid-swap keeps the spilled K/V and the rejected
    bookkeeping; the restored cluster resumes the swap and finishes with
    the greedy reference's tokens."""
    _, _, cfg, params = weights
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab_size, size=20).tolist() for _ in range(2)]
    kw = dict(num_prefill=1, num_decode=1, num_blocks=3)
    client = FlowKVClient(cfg, params, device="cpu",
                          admission=AdmissionPolicy(ttft_slo_s=1e-12, reject_factor=1.0), **kw)
    rej = client.submit(prompts[0], SamplingParams(max_new_tokens=2))
    assert rej.rejected
    client.controller.admission = None
    handles = [client.submit(p, SamplingParams(max_new_tokens=20)) for p in prompts]
    swapped = None
    for _ in range(400):
        client.step()
        swapped = next((h for h in handles if h.request.state is RequestState.SWAPPED), None)
        if swapped is not None or all(h.done for h in handles):
            break
    assert swapped is not None
    dnode = client.cluster.engines[swapped.request.decode_node]
    assert swapped.request_id in dnode.spilled
    CK.save_cluster(client.cluster, str(tmp_path / "ckpt"))

    c2 = _cluster(weights, **kw)
    CK.load_cluster(c2, str(tmp_path / "ckpt"))
    assert len(c2.rejected) == 1
    assert c2.rejected[0].state is RequestState.REJECTED
    assert c2.rejected[0].retry_after == rej.retry_after
    d2 = c2.engines[swapped.request.decode_node]
    k, v, length = d2.spilled[swapped.request_id]
    k0, v0, length0 = dnode.spilled[swapped.request_id]
    assert length == length0
    assert k.dtype == k0.dtype and torch.equal(k, k0) and torch.equal(v, v0)
    _finish(c2, 2, max_cycles=400)
    want = _greedy(weights, prompts, 20)
    assert all(want[key] == out for key, out in _outs(c2).items())
    assert c2.audit_blocks() == 0


def test_restore_onto_used_cluster_resets_block_state(tmp_path, weights):
    rng = np.random.RandomState(7)
    donor = rng.randint(0, weights[2].vocab_size, size=74).tolist()
    cluster = _cluster(weights, num_prefill=1, num_decode=1, num_blocks=128)
    r1 = _request(donor, 12)
    cluster.submit(r1)
    for _ in range(3):
        cluster.step()
    CK.save_cluster(cluster, str(tmp_path / "ckpt"))
    r2 = _request(donor[:40], 12)             # the live state diverges from the snapshot
    cluster.submit(r2)
    for _ in range(3):
        cluster.step()
    CK.load_cluster(cluster, str(tmp_path / "ckpt"))
    for e in cluster.engines.values():
        e.scheduler.bm.check_invariants()
    bms = [e.scheduler.bm for e in cluster.engines.values()]
    assert not any(bm.owns(r2.request_id) for bm in bms)
    assert any(bm.owns(r1.request_id) for bm in bms)
    assert not cluster.controller.prefix_index.has_entries


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def _pair(weights, port, **kw):
    """A cluster of either package under the reference's profile and target."""
    rcfg, rparams, cfg, params = weights
    if port:
        return PDCluster(cfg, params, device="cpu", hardware=TPU_V5E, target="tpu", **kw)
    return RefCluster(rcfg, rparams, hardware=REF_V5E, **kw)


def _tables(cluster):
    return {nid: {int(r): list(map(int, b)) for r, b in e.scheduler.bm._table.items()}
            for nid, e in cluster.engines.items()}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages(tmp_path, weights, writer):
    """A checkpoint one package writes mid-flight finishes in the other with
    the writer's own tokens and, step by step, its block tables."""
    kw = dict(num_prefill=1, num_decode=2, num_blocks=64)
    prompts = _prompts(weights[2].vocab_size, n=4, seed=11)
    src = _pair(weights, writer == "port", **kw)
    for p in prompts:
        src.submit((_request if writer == "port" else
                    lambda q, s: RefRequest(prompt_tokens=list(q),
                                            sampling=RefSampling(max_new_tokens=s)))(p, 6))
    for _ in range(4):
        src.step()
    (CK if writer == "port" else RCK).save_cluster(src, str(tmp_path / "ckpt"))

    runs = {}
    for port in (True, False):
        c = _pair(weights, port, **kw)
        (CK if port else RCK).load_cluster(c, str(tmp_path / "ckpt"))
        trail = [_tables(c)]
        for _ in range(60):
            if len(c.finished) >= len(prompts):
                break
            c.step()
            trail.append(_tables(c))
        assert len(c.finished) == len(prompts)
        runs[port] = (c, trail)
    (pc, ptrail), (rc, rtrail) = runs[True], runs[False]
    assert ptrail == rtrail
    assert _outs(pc) == _outs(rc) == _greedy(weights, prompts, 6)
    assert pc.audit_blocks() == 0
    pc.assert_no_leaks()
