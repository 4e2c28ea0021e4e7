"""The port's state transfer path on the CPU, against the reference: the
mamba2-370m (ssm) and recurrentgemma-2b (hybrid) smoke configs served
1P+1D through both packages' ``PDCluster`` on the reference's own weights
(bridged), under faults, across a checkpoint, through the launcher, and in
the simulator; seamless-m4t-large-v2 (encdec) and TP 2 refused by both.

Bars: tokens equal to the reference cluster's and to the port's monolithic
generation (prefill, then the decode loop); every transfer one ``state``
job of 1 dispatch with the reference's calls (one per cache leaf: 5 and 11)
and bytes; every stats entry equal to the reference's under the same
hardware profile; ``engine.states`` empty and no leaked block at the end.
The fault cases are in ``test_torch_state_faults.py``. A checkpoint taken mid-stream restores as the reference's
does (it saves no request state). ``launch/serve.py --device cpu`` prints
the reference launcher's outputs, and ``--engine sim`` its stats for all
three archs.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.distributed import tp as RTP  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving import checkpoint as RCK  # noqa: E402
from repro.serving.cluster import PDCluster as RefCluster  # noqa: E402
from repro.serving.engine import NodeEngine as RefEngine  # noqa: E402
from repro.serving.request import Request as RefRequest  # noqa: E402
from repro.serving.request import SamplingParams as RefSampling  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.transfer import backend_for_engine  # noqa: E402
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api as API  # noqa: E402
from repro_torch.models.bridge import from_reference  # noqa: E402
from repro_torch.serving import checkpoint as CK  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.engine import NodeEngine  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402
from repro_torch.sim.hardware import TPU_V5E  # noqa: E402

ARCHS = ["mamba2-370m", "recurrentgemma-2b"]
LEAVES = {"mamba2-370m": 5, "recurrentgemma-2b": 11}
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    rcfg = ref_smoke(arch)
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    return rcfg, rparams, cfg, from_reference(jax.tree.map(np.asarray, rparams), cfg,
                                              device="cpu")


def _prompts(vocab, lengths=(9, 30), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in lengths]


def _cluster(port, arch, **kw):
    rcfg, rparams, cfg, params = _weights(arch)
    kw = {"num_prefill": 1, "num_decode": 1, "num_blocks": 64, **kw}
    if port:   # the reference's defaults: a TPU v5e profile and the TPU routes
        return PDCluster(cfg, params, device="cpu", hardware=TPU_V5E, target="tpu", **kw)
    return RefCluster(rcfg, rparams, **kw)


def _request(port, prompt, steps=STEPS):
    if port:
        return Request(prompt_tokens=list(prompt), sampling=SamplingParams(max_new_tokens=steps))
    return RefRequest(prompt_tokens=list(prompt), sampling=RefSampling(max_new_tokens=steps))


def _outs(cluster):
    return {tuple(map(int, r.prompt_tokens[:r.client_prompt_len or None])):
            list(map(int, r.output_tokens)) for r in cluster.finished}


def _records(cluster):
    return [(t.kind, t.status, t.schedule, t.num_calls, t.num_bytes, t.num_dispatches,
             t.retries) for t in cluster.transfers]


def _monolithic(arch, prompt, steps=STEPS):
    """The port's generation without the cluster: prefill, then decode."""
    _, _, cfg, params = _weights(arch)
    model = API.get_model(cfg)
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt], dtype=torch.int32)})
    out = [int(torch.argmax(logits[0]))]
    while len(out) < steps:
        logits, cache = model.decode(params, torch.tensor(out[-1:], dtype=torch.int32), cache)
        out.append(int(torch.argmax(logits[0])))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_state_serving_equals_reference(arch):
    """Tokens, transfer jobs, decode accounting and every stat equal to the
    reference's; the state job's bytes are its leaves' bytes; no leftovers."""
    cfg = _weights(arch)[2]
    prompts = _prompts(cfg.vocab_size)
    runs = {}
    for port in (True, False):
        cluster = _cluster(port, arch)
        done = cluster.run([_request(port, p) for p in prompts], max_cycles=300)
        assert len(done) == len(prompts)
        runs[port] = cluster
    port, ref = runs[True], runs[False]
    assert _outs(port) == _outs(ref) == {tuple(p): _monolithic(arch, p) for p in prompts}
    assert _records(port) == _records(ref)
    assert all(r[:3] == ("kv", "ok", "state") and r[3] == LEAVES[arch] and r[5] == 1
               for r in _records(port))
    assert port.stats() == ref.stats()
    s = port.stats()
    assert s["decode_steps"] > 0 and s["mean_transfer_dispatches"] == 1.0
    for r in port.finished:
        assert r.transfer_calls == LEAVES[arch] and r.transfer_dispatches == 1
    for eng in port.engines.values():
        assert eng.kv is None and not eng.paged and eng.states == {}
        assert not eng.supports_prefix_reuse and not eng.supports_chunked_prefill
    assert port.audit_blocks() == 0
    port.assert_no_leaks()


@pytest.mark.parametrize("arch", ARCHS)
def test_state_job_moves_the_state_by_reference(arch):
    """``StateBackend``: one job of 1 dispatch, one call per leaf, the
    leaves' bytes; execute hands the very tensors to the destination."""
    _, _, cfg, params = _weights(arch)
    prompt = _prompts(cfg.vocab_size, (21,))[0]
    src = NodeEngine(0, cfg, params, num_blocks=16, device="cpu")
    dst = NodeEngine(1, cfg, params, num_blocks=16, device="cpu")
    req = _request(True, prompt)
    src.scheduler.enqueue_prefill(req)
    src.step()
    state = src.states[req.request_id]
    backend = backend_for_engine(src)
    job = backend.plan(req, src, dst)
    assert (backend.name, job.backend, job.schedule, job.num_dispatches) == \
        ("state", "state", "state", 1)
    assert job.num_calls == len(state) == LEAVES[arch]
    assert job.num_bytes == sum(t.numel() * t.element_size() for t in state.values())
    assert dst.scheduler.bm.owns(req.request_id)      # the dst reserved its budget
    backend.execute(job, src, dst)
    assert req.request_id not in src.states
    assert all(dst.states[req.request_id][k] is v for k, v in state.items())


@pytest.mark.parametrize("arch", ARCHS)
def test_state_checkpoint_roundtrip_as_reference(tmp_path, arch):
    """Saved mid-stream, restored into a fresh cluster: the reference saves
    block tables and queues but no request state, so both packages restore
    the same tables and queues, and finishing ends the same way in both
    (here: the first decode of a restored request finds no state)."""
    cfg = _weights(arch)[2]
    prompts = _prompts(cfg.vocab_size)
    result = {}
    for port in (True, False):
        ck = CK if port else RCK
        cluster = _cluster(port, arch)
        reqs = [_request(port, p, 6) for p in prompts]
        idx = {r.request_id: i for i, r in enumerate(reqs)}   # ids differ by package
        for r in reqs:
            cluster.submit(r)
        for _ in range(3):
            cluster.step()
        path = str(tmp_path / f"ckpt_{port}")
        ck.save_cluster(cluster, path)
        c2 = _cluster(port, arch)
        ck.load_cluster(c2, path)
        tables = {n: {idx[rid]: list(b) for rid, b in e.scheduler.bm._table.items()}
                  for n, e in c2.engines.items()}
        queues = {n: {q: [(idx[d["request_id"]], d["state"], d["output_tokens"]) for d in ds]
                      for q, ds in node["queues"].items()}
                  for n, node in c2.checkpoint()["nodes"].items()}
        try:
            for _ in range(80):
                if len(c2.finished) >= len(prompts):
                    break
                c2.step()
            outcome = ("finished", _outs(c2))
        except KeyError as exc:            # a restored request without its state
            outcome = ("KeyError", idx[exc.args[0]])
        result[port] = (tables, queues, outcome, c2.clock)
    assert result[True] == result[False]
    assert any(result[True][0].values()), "nothing was in flight at the checkpoint"


def test_launcher_outputs_equal_reference(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch mamba2-370m``
    prints the reference launcher's outputs when its init is the
    reference's weights (bridged): ``jax.random`` cannot be reproduced."""
    weights = _weights("mamba2-370m")[3]
    real = API.get_model
    monkeypatch.setattr(API, "get_model", lambda cfg: dataclasses.replace(
        real(cfg), init=lambda seed=0, device=None: weights))
    argv = ["--arch", "mamba2-370m", "--requests", "3", "--max-new-tokens", "3"]
    out = []
    for main, extra in ((serve.main, ["--device", "cpu"]), (ref_serve.main, [])):
        monkeypatch.setattr("sys.argv", ["serve", *argv, *extra])
        main()
        out.append(json.loads(capsys.readouterr().out))
    port, ref = out
    assert port["device"] == "cpu"
    # request ids come from a process-wide counter: compare in submit order
    assert list(port["outputs"].values()) == list(ref["outputs"].values())
    assert len(port["outputs"]) == 3
    assert port["finished"] == ref["finished"] == 3
    assert port["mean_transfer_calls"] == ref["mean_transfer_calls"] == 5.0
    assert port["decode_dispatches"] == ref["decode_dispatches"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b", "seamless-m4t-large-v2"])
def test_engine_sim_equals_reference(arch, monkeypatch, capsys):
    """``--engine sim``: the port's ClusterSim gives the reference's stats
    for the state families at their full configs."""
    out = []
    for main in (serve.main, ref_serve.main):
        monkeypatch.setattr("sys.argv", ["serve", "--engine", "sim", "--arch", arch,
                                         "--workload", "1k", "--rps", "1.0"])
        main()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    stats = json.loads(out[0])
    assert stats["finished"] == stats["offered"] > 0


def test_both_packages_refuse_encdec_serving_and_tp():
    """seamless cannot be served by either package (its prefill needs
    encoder frames, which requests lack), and neither runs the state
    families at TP 2."""
    arch = "seamless-m4t-large-v2"
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    ref = RefCluster(rcfg, rparams, num_prefill=1, num_decode=1, num_blocks=16)
    with pytest.raises(KeyError, match="frames"):
        ref.run([_request(False, [1, 2, 3], 2)], max_cycles=20)
    params = API.get_model(cfg).init(0, "cpu")
    with pytest.raises(ValueError, match="frames"):
        PDCluster(cfg, params, num_blocks=16, device="cpu")
    for arch in ARCHS + [arch]:
        rcfg, rparams, cfg, params = (*_weights(arch),) if arch in ARCHS else \
            (rcfg, rparams, cfg, params)
        for validate, c in ((RTP.validate_tp, rcfg), (TP.validate_tp, cfg)):
            validate(c, 1)
            with pytest.raises(ValueError, match="tensor parallelism"):
                validate(c, 2)
        if arch in ARCHS:
            with pytest.raises(ValueError, match="paged-KV family"):
                RefEngine(0, rcfg, rparams, num_blocks=8, tp_degree=2)
            with pytest.raises(ValueError, match="paged-KV family"):
                NodeEngine(0, cfg, params, num_blocks=8, tp_degree=2, device="cpu")
