"""The port's prefill data plane end to end on the CPU, against the
reference: prefix reuse (local hit, cross-node fetch, reuse off, cancel
while shared), chunked prefill (cold and on a prefix hit), continuous
batching and layer-window transfer, each run by BOTH packages' PDCluster on
the qwen3-1.7b smoke config with the reference's weights bridged.

Every case runs at the default ``flash_threshold`` (prefill attention is
plain ``attend``) and at ``flash_threshold = 16``, where every prompt and
suffix takes the flash branch — K4's wrapper, whose CPU branch is the plain
version — and every prefill write and prefix read goes through K5b / K5a.

Bars: the port's tokens equal the reference's and the port's monolithic
``greedy_generate``; the reuse counters and the ``(kind, num_dispatches)``
transfer lists equal the reference's; no leaked blocks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.obs.tracing import attach_tracer as ref_attach_tracer  # noqa: E402
from repro.serving.cluster import PDCluster as RefCluster  # noqa: E402
from repro.serving.request import Request as RefRequest  # noqa: E402
from repro.serving.request import SamplingParams as RefSampling  # noqa: E402
from repro.sim.hardware import TPU_V5E as REF_V5E  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.bridge import from_reference  # noqa: E402
from repro_torch.obs.tracing import attach_tracer  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402
from repro_torch.sim.hardware import TPU_V5E  # noqa: E402

COUNTERS = ("finished", "prefix_hits", "prefix_tokens_reused",
            "prefill_tokens_computed", "prefix_fetches", "transfers", "decode_steps")
THRESHOLDS = [None, 16]          # None: the config's own (1024)


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
    params = from_reference(jax.tree.map(np.asarray, rparams),
                            get_smoke_config("qwen3-1.7b"), device="cpu")
    return rparams, params


class Side:
    """One package's cluster, request types and config at a threshold."""

    def __init__(self, port: bool, weights, threshold):
        self.port = port
        cfg = get_smoke_config("qwen3-1.7b") if port else ref_smoke("qwen3-1.7b")
        if threshold is not None:
            cfg = dataclasses.replace(cfg, flash_threshold=threshold)
        self.cfg = cfg
        self.params = weights[1] if port else weights[0]
        self.weak = dataclasses.replace(TPU_V5E if port else REF_V5E, peak_flops=1e6)

    def cluster(self, **kw):
        if self.port:
            return PDCluster(self.cfg, self.params, device="cpu", **kw)
        return RefCluster(self.cfg, self.params, **kw)

    def request(self, prompt, steps):
        if self.port:
            return Request(prompt_tokens=list(prompt),
                           sampling=SamplingParams(max_new_tokens=steps))
        return RefRequest(prompt_tokens=list(prompt), sampling=RefSampling(max_new_tokens=steps))

    def tracer(self, cluster):
        return attach_tracer(cluster) if self.port else ref_attach_tracer(cluster)


def _sides(weights, threshold):
    return Side(True, weights, threshold), Side(False, weights, threshold)


def _monolithic(side, prompts, steps):
    """The port's greedy_generate (cheap); the reference's cluster is
    compared with the port's cluster directly."""
    steps = steps if isinstance(steps, dict) else {tuple(p): steps for p in prompts}
    return {tuple(p): T.greedy_generate(side.params, side.cfg,
                                        torch.tensor([p], dtype=torch.int32),
                                        steps[tuple(p)])[0].tolist()
            for p in prompts}


def _shared_prompts(vocab, n_followers=2, prefix_len=64, seed=7):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, size=prefix_len).tolist()
    donor = prefix + rng.randint(0, vocab, size=10).tolist()
    followers = [prefix + rng.randint(0, vocab, size=5 + 3 * i).tolist()
                 for i in range(n_followers)]
    return donor, followers


def _staggered(side, donor, followers, steps=5, warm=3, **kw):
    """Donor first; followers submitted once the donor's KV is resident."""
    kw = {"num_blocks": 128, "max_batch_tokens": 4096, **kw}
    cluster = side.cluster(**kw)
    rec = side.tracer(cluster)
    reqs = [side.request(p, steps) for p in [donor] + followers]
    cluster.submit(reqs[0])
    for _ in range(warm):
        cluster.step()
    for r in reqs[1:]:
        cluster.submit(r)
    for _ in range(150):
        cluster.step()
        if len(cluster.finished) == len(reqs):
            break
    assert len(cluster.finished) == len(reqs)
    return cluster, reqs, rec


def _outs(cluster):
    return {tuple(r.prompt_tokens): list(r.output_tokens) for r in cluster.finished}


def _same_run(port, ref):
    """Tokens, counters and transfer lists equal across the packages; no leaks."""
    assert _outs(port) == _outs(ref)
    ps, rs = port.stats(), ref.stats()
    assert {k: ps[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    assert [(t.kind, t.num_dispatches) for t in port.transfers] == \
        [(t.kind, t.num_dispatches) for t in ref.transfers]
    assert ps["leaked_blocks"] == 0.0
    for e in port.engines.values():
        e.scheduler.bm.check_invariants()
    return ps


def _chunks(rec, request_id):
    return sorted((s.attrs["offset"], s.attrs["tokens"]) for s in rec.spans
                  if s.name == "prefill_chunk" and s.trace_id == request_id)


# ---------------------------------------------------------------------------
# prefix reuse
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_local_hit_token_identity_and_exact_savings(weights, threshold, monkeypatch):
    from repro_torch.kernels.flash_prefill import ops

    offsets = []
    plain = ops.flash_prefill_ref
    monkeypatch.setattr(ops, "flash_prefill_ref", lambda *a, **kw: (
        offsets.append(kw["q_offset"]), plain(*a, **kw))[1])
    pt, rf = _sides(weights, threshold)
    donor, followers = _shared_prompts(pt.cfg.vocab_size)
    runs = [_staggered(s, donor, followers, num_prefill=1, num_decode=0) for s in (pt, rf)]
    # K4's wrapper carries the prefill above the threshold, cold and suffix
    if threshold is None:
        assert offsets == []
    else:
        assert 0 in offsets and 64 in offsets
    s = _same_run(runs[0][0], runs[1][0])
    assert _outs(runs[0][0]) == _monolithic(pt, [donor] + followers, 5)
    assert s["prefix_hits"] == len(followers)
    assert s["prefix_tokens_reused"] == 64 * len(followers)
    total = sum(r.prompt_len for r in runs[0][1])
    assert s["prefill_tokens_computed"] == total - s["prefix_tokens_reused"]
    assert s["prefix_fetches"] == 0


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_remote_fetch_token_identity_one_fused_dispatch(weights, threshold):
    pt, rf = _sides(weights, threshold)
    donor, followers = _shared_prompts(pt.cfg.vocab_size)
    runs = [_staggered(s, donor, followers, num_prefill=1, num_decode=1, hardware=s.weak)
            for s in (pt, rf)]
    cluster, reqs, _ = runs[0]
    s = _same_run(cluster, runs[1][0])
    assert _outs(cluster) == _monolithic(pt, [donor] + followers, 5)
    assert s["prefix_hits"] >= 1 and s["prefix_fetches"] >= 1
    assert s["prefill_tokens_computed"] == sum(r.prompt_len for r in reqs) - \
        s["prefix_tokens_reused"]
    fetches = [t for t in cluster.transfers if t.kind == "prefix_fetch"]
    assert fetches and all(t.num_dispatches == 1 for t in fetches)
    assert [r.prefix_fetch_dispatches for r in reqs] == \
        [r.prefix_fetch_dispatches for r in runs[1][1]]


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_reuse_off_is_cold_everywhere(weights, threshold):
    pt, rf = _sides(weights, threshold)
    donor, followers = _shared_prompts(pt.cfg.vocab_size)
    runs = [_staggered(s, donor, followers, num_prefill=1, num_decode=0, prefix_reuse=False)
            for s in (pt, rf)]
    s = _same_run(runs[0][0], runs[1][0])
    assert _outs(runs[0][0]) == _monolithic(pt, [donor] + followers, 5)
    assert s["prefix_hits"] == 0 and s["prefix_tokens_reused"] == 0
    assert s["prefill_tokens_computed"] == sum(r.prompt_len for r in runs[0][1])


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_cancel_while_shared_no_leak(weights, threshold):
    """Cancelling the donor while a follower shares its blocks neither frees
    the shared blocks under the follower nor leaks them after."""
    outs = []
    for side in _sides(weights, threshold):
        donor, followers = _shared_prompts(side.cfg.vocab_size, n_followers=1)
        cluster = side.cluster(num_prefill=1, num_decode=0, num_blocks=128)
        d, f = side.request(donor, 40), side.request(followers[0], 5)
        cluster.submit(d)
        for _ in range(3):
            cluster.step()
        cluster.submit(f)
        cluster.step()
        bm = cluster.engines[0].scheduler.bm
        assert f.num_cached_prefix_tokens == 64
        shared = f.prefix_block_ids
        assert shared and all(bm.refcount(b) == 2 for b in shared)
        assert cluster.cancel(d)
        bm.check_invariants()
        assert all(bm.refcount(b) == 1 for b in shared)
        for _ in range(60):
            cluster.step()
            if cluster.finished:
                break
        bm.check_invariants()
        assert bm.free_capacity == bm.num_blocks
        outs.append(list(cluster.finished[0].output_tokens))
    assert outs[0] == outs[1]
    assert outs[0] == _monolithic(Side(True, weights, threshold), followers, 5)[
        tuple(followers[0])]


# ---------------------------------------------------------------------------
# chunked prefill and continuous batching
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("chunk_tokens", [32, 48])
def test_chunked_matches_monolithic(weights, threshold, chunk_tokens):
    runs = []
    for side in _sides(weights, threshold):
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, side.cfg.vocab_size, size=n).tolist()
                   for n in (100, 61, 33, 20)]
        cluster = side.cluster(num_prefill=1, num_decode=1, num_blocks=128,
                               prefix_reuse=False, chunked_prefill=True,
                               prefill_chunk_tokens=chunk_tokens)
        rec = side.tracer(cluster)
        done = cluster.run([side.request(p, 5) for p in prompts], max_cycles=120)
        assert len(done) == len(prompts)
        runs.append((cluster, rec))
    (port, prec), (ref, rrec) = runs
    _same_run(port, ref)
    assert _outs(port) == _monolithic(_sides(weights, threshold)[0], prompts, 5)
    long_p = next(r for r in port.finished if r.prompt_len == 100)
    long_r = next(r for r in ref.finished if r.prompt_len == 100)
    spans = _chunks(prec, long_p.request_id)
    assert len(spans) >= 2 and spans == _chunks(rrec, long_r.request_id)
    pos = 0
    for off, tok in spans:
        assert off == pos
        pos += tok
    assert pos == 100


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_chunked_matches_monolithic_on_prefix_hit(weights, threshold):
    """The chunk loop resumes AFTER a cached prefix, token-identically."""
    pt, rf = _sides(weights, threshold)
    rng = np.random.RandomState(11)
    prefix = rng.randint(0, pt.cfg.vocab_size, size=64).tolist()
    donor = prefix + rng.randint(0, pt.cfg.vocab_size, size=10).tolist()
    followers = [prefix + rng.randint(0, pt.cfg.vocab_size, size=70 + 7 * i).tolist()
                 for i in range(2)]
    runs = [_staggered(s, donor, followers, steps=4, warm=4, num_prefill=1, num_decode=0,
                       chunked_prefill=True, prefill_chunk_tokens=32) for s in (pt, rf)]
    (port, reqs, rec), (ref, rreqs, rrec) = runs
    s = _same_run(port, ref)
    assert _outs(port) == _monolithic(pt, [donor] + followers, 4)
    assert s["prefix_hits"] >= 1
    hit = next(r for r in reqs[1:] if r.num_cached_prefix_tokens > 0)
    spans = _chunks(rec, hit.request_id)
    assert len(spans) >= 2 and spans[0][0] == hit.num_cached_prefix_tokens
    assert sum(t for _, t in spans) == hit.prompt_len - hit.num_cached_prefix_tokens
    rhit = next(r for r in rreqs if r.prompt_tokens == hit.prompt_tokens)
    assert spans == _chunks(rrec, rhit.request_id)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_continuous_join_and_leave_identity(weights, threshold):
    """A late request joins while others decode and an early one leaves,
    without perturbing anyone's tokens."""
    runs = []
    for side in _sides(weights, threshold):
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, side.cfg.vocab_size, size=n).tolist() for n in (90, 70, 25)]
        steps = [10, 3, 6]
        cluster = side.cluster(num_prefill=1, num_decode=1, num_blocks=128,
                               prefix_reuse=False, chunked_prefill=True,
                               prefill_chunk_tokens=32)
        reqs = [side.request(p, n) for p, n in zip(prompts, steps)]
        cluster.submit(reqs[0])
        cluster.submit(reqs[1])
        late = joined = False
        for _ in range(200):
            cluster.step()
            decoding = {r.request_id for e in cluster.engines.values()
                        for r in e.scheduler.decode.running}
            if not late and reqs[0].request_id in decoding:
                cluster.submit(reqs[2])
                late = True
            if late and {reqs[0].request_id, reqs[2].request_id} <= decoding:
                joined = True
            if len(cluster.finished) == len(reqs):
                break
        assert len(cluster.finished) == len(reqs) and joined
        order = [r.request_id for r in cluster.finished]
        assert order.index(reqs[1].request_id) < order.index(reqs[0].request_id)
        runs.append(cluster)
    _same_run(*runs)
    want = _monolithic(_sides(weights, threshold)[0], prompts,
                       {tuple(p): n for p, n in zip(prompts, steps)})
    assert _outs(runs[0]) == want


# ---------------------------------------------------------------------------
# layer-window transfer with prefix fetch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_layer_window_transfer_with_prefix_fetch(weights, threshold):
    """layer_window=1 streams each P->D transfer as one sub-plan per layer,
    each its own dispatch, next to one-dispatch prefix fetches."""
    pt, rf = _sides(weights, threshold)
    donor, followers = _shared_prompts(pt.cfg.vocab_size)
    runs = [_staggered(s, donor, followers, num_prefill=1, num_decode=1, hardware=s.weak,
                       layer_window=1) for s in (pt, rf)]
    port = runs[0][0]
    s = _same_run(port, runs[1][0])
    assert _outs(port) == _monolithic(pt, [donor] + followers, 5)
    kinds = [(t.kind, t.num_dispatches) for t in port.transfers]
    assert ("prefix_fetch", 1) in kinds
    assert all(n == pt.cfg.num_layers for k, n in kinds if k == "kv")
    assert s["transfers"] == 3
