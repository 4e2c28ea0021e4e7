"""granitemoehybrid served through the port's normal path (``PDCluster`` of
``NodeEngine``s), on the CPU at the smoke size (fp32), held against the
plain reference (``flowbench/reference/granitemoehybrid.py``):

* chunked prefill carrying the state slot, then the paged + slot decode
  step, gives the reference's full-forward logits at every served token;
* a request prefilled on P, moved (page plan + one state copy) and decoded
  on D gives one engine's logits, and its job counts the page plan's calls
  and dispatches plus one and the slot's bytes;
* a ragged batch with pad lanes (on the scratch block and slot) gives each
  request's logits decoded alone;
* a request spilled mid-decode (pages and slot row to the host) and
  resumed is bit-equal to one never spilled; prefix reuse stays off;
* a request waits for a free state slot, as it would for blocks;
* on the card (``gpu`` marker; skipped without an sm_90 device), the
  step replayed from its CUDA graphs (slot ids a staged input) gives the
  eager step's tokens and logits bit for bit, and the reference's logits.

The logits are read where the engine makes them: its prefill chunk and
``Model.decode_paged``, wrapped on the engine. No JAX.
"""
import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")

from flowbench import harness  # noqa: E402
from repro_torch.configs import granite_4_0_h_small as G4  # noqa: E402
from repro_torch.core.scheduler.hybrid_scheduler import ScheduleDecision  # noqa: E402
from repro_torch.core.transfer import TransferPlanner  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = harness.load_module(ROOT / "flowbench" / "reference" / "granitemoehybrid.py",
                          "granite_reference_serving_test")
FAMILY = harness.load_module(ROOT / "flowbench" / "families" / "granitemoehybrid.py",
                             "granite_family_serving_test")
CFG = G4.smoke_config()
FILE = FAMILY.file_for(CFG)
SEED = 2**31 + 41


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return REF.make_weights(FILE, SEED, "cpu")


def _prompt(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, (n,), generator=g).tolist()


def _record(cluster):
    """Keep each request's logits where its engines make them: ``{request_id:
    [logits of each served token]}`` (its final prefill chunk's, then its
    lane of each decode step: what ``Model.decode_paged``, wrapped on the
    model, returns, or on the card what the engine's graphs return)."""
    seen = {}
    for eng in cluster.engines.values():
        def chunk(req, offset, tokens, k_pre, v_pre, _f=eng._prefill_slot_chunk):
            logits, cache = _f(req, offset, tokens, k_pre, v_pre)
            if offset + tokens.shape[1] == req.prompt_len:
                seen.setdefault(req.request_id, []).append(logits[0].clone())
            return logits, cache

        def decode(p, tok, pool, bt, lens, slot_ids, slots, _f=eng.model.decode_paged, _e=eng):
            logits, pool = _f(p, tok, pool, bt, lens, slot_ids, slots)
            _e._last_step = logits
            return logits, pool

        eng._prefill_slot_chunk = chunk
        eng.model = dataclasses.replace(eng.model, decode_paged=decode)
        if eng.graphs is not None:
            # a replay calls no Python, and a capture's own call returns the
            # graph's output before any replay fills it: keep what run gives
            def run(*a, _f=eng.graphs.run, _e=eng):
                logits, how = _f(*a)
                _e._last_step = logits
                return logits, how

            eng.graphs.run = run

        def dec(decision, _r=eng.run_decode, _e=eng):
            batch = list(decision.decode_batch)
            out = _r(decision)
            for i, req in enumerate(batch):
                seen.setdefault(req.request_id, []).append(_e._last_step[i].clone())
            return out

        eng.run_decode = dec
    return seen


def _cluster(params, num_decode=1, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_batch_tokens", 16)
    return PDCluster(CFG, params, num_prefill=1, num_decode=num_decode, device="cpu", **kw)


def _serve(cluster, prompts, new=5):
    reqs = [Request(prompt_tokens=p, sampling=SamplingParams(max_new_tokens=new))
            for p in prompts]
    cluster.run(reqs, max_cycles=500)
    return reqs


def _reference(params, req, file=FILE):
    seq = req.prompt_tokens + req.output_tokens[:-1]
    return REF.logits_at(params, file, seq, range(req.prompt_len - 1, len(seq)))


@pytest.mark.parametrize("length,chunk", [(5, 8), (29, 8), (64, 8), (100, 16)])
def test_the_batched_ssd_is_the_chunk_loop(length, chunk):
    # every SSD chunk at once against mamba2's loop over them, from a
    # nonzero carried state; fp32, sums in another order: 1e-5 of values ~10
    from repro_torch.models.granite_hybrid import ssd_chunks
    from repro_torch.models.mamba2 import _ssd_chunked
    g = torch.Generator().manual_seed(length)
    la = -2 * torch.rand((1, length, 3), generator=g)
    Bm, Cm = torch.randn((1, length, 6), generator=g), torch.randn((1, length, 6), generator=g)
    x, h0 = torch.randn((1, length, 3, 4), generator=g), torch.randn((1, 3, 4, 6), generator=g)
    (y, h), (y2, h2) = _ssd_chunked(la, Bm, Cm, x, h0, chunk), ssd_chunks(la, Bm, Cm, x, h0, chunk)
    assert torch.allclose(y2, y, atol=1e-5, rtol=1e-5) and torch.allclose(h2, h, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tokens", [2, 37])
def test_a_chunks_expert_share_is_that_of_its_tokens_one_by_one(params, tokens):
    # the one dispatch serves a prefill chunk and a decode step's one-token
    # lanes: the chunk's rows against each token alone (fp32, the same
    # products batched another way: 1e-6 of values ~1)
    from repro_torch.models import moe as MOE
    lp = {k[len("moe_"):]: v[1] for k, v in params["layers"].items() if k.startswith("moe_")}
    x = torch.randn((1, tokens, CFG.d_model), generator=torch.Generator().manual_seed(tokens))
    alone = torch.cat([MOE.moe_share_ffn(lp, x[:, i:i + 1], CFG) for i in range(tokens)], 1)
    assert torch.allclose(MOE.moe_share_ffn(lp, x, CFG), alone, atol=1e-6, rtol=1e-5)


def test_chunked_prefill_then_paged_slot_decode_is_the_reference(params):
    # a 45-token prompt in chunks of 16 (the state carried twice, K4's plain
    # version on the last: 45 > flash_threshold 40), then 6 decode steps on
    # one node; fp32, the reference sums in other orders: 1e-5 of logits ~1e-2
    cl = _cluster(params, num_decode=0)
    seen = _record(cl)
    req, = _serve(cl, [_prompt(45, 1)], new=7)
    got = torch.stack(seen[req.request_id])
    assert got.shape[0] == 7 and len(req.output_tokens) == 7
    want = _reference(params, req)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-4), float((got - want).abs().max())
    assert req.output_tokens == got.argmax(-1).tolist()
    eng = cl.engines[0]
    assert eng.prefill_tokens_computed == 45 and eng.decode_graph_captures == 0
    assert eng.slots.num_held == 0 and eng.state_slots_peak == 1
    assert cl.audit_blocks() == 0


def test_a_request_moved_p_to_d_decodes_as_on_one_engine(params):
    prompts = [_prompt(45, 2), _prompt(19, 3)]
    one = _cluster(params, num_decode=0)
    seen_one = _record(one)
    want = _serve(one, prompts)
    pd = _cluster(params)
    seen = _record(pd)
    got = _serve(pd, prompts)
    p, d = pd.engines[0], pd.engines[1]
    for a, b in zip(want, got):
        assert a.output_tokens == b.output_tokens
        assert torch.allclose(torch.stack(seen_one[a.request_id]),
                              torch.stack(seen[b.request_id]), atol=1e-6, rtol=1e-5)
    spec = p.kv.spec
    for rec, req in zip(pd.transfers, got):
        n = spec.blocks_for_tokens(req.prompt_len)
        plan = TransferPlanner(spec).plan("flowkv", list(range(n)), list(range(n)))
        assert rec.status == "ok" and rec.num_calls == plan.num_calls + 1
        assert rec.num_dispatches == 2
        assert rec.num_bytes == plan.total_bytes + CFG.state_slot_bytes()
    # every slot back: P's left with the transfer, D's at the finish
    assert p.slots.num_held == d.slots.num_held == 0
    assert p.state_slots_peak >= 1 and d.state_slots_peak >= 1
    assert pd.audit_blocks() == 0


def test_the_transfer_span_splits_page_and_state_bytes(params):
    from repro_torch.obs.tracing import attach_tracer
    pd = _cluster(params)
    rec = attach_tracer(pd)
    req, = _serve(pd, [_prompt(30, 4)], new=3)
    span, = rec.by_name("transfer")
    assert span.attrs["state_bytes"] == CFG.state_slot_bytes()
    assert span.attrs["page_bytes"] + span.attrs["state_bytes"] == span.attrs["bytes"]
    assert span.attrs["calls"] == pd.transfers[0].num_calls
    steps = rec.by_name("decode_step")
    assert steps and all(s.attrs["state_bytes"] == 2 * s.attrs["batch"]
                         * CFG.state_slot_bytes() for s in steps)


def test_a_ragged_batch_with_pad_lanes_is_each_request_alone(params):
    # three requests decode together in a 4-lane bucket (one pad lane on the
    # scratch slot and block); alone each runs a 1-lane bucket. Row for row
    # the same arithmetic: 1e-6 of logits ~1e-2
    prompts = [_prompt(21, 5), _prompt(9, 6), _prompt(33, 7)]
    together = _cluster(params, max_batch_tokens=128)
    seen = _record(together)
    reqs = _serve(together, prompts, new=6)
    assert max(together.engines[1]._decode_cache_keys)[0] == 4
    for prompt, req in zip(prompts, reqs):
        alone = _cluster(params, max_batch_tokens=128)
        seen_alone = _record(alone)
        ref, = _serve(alone, [prompt], new=6)
        assert ref.output_tokens == req.output_tokens
        assert torch.allclose(torch.stack(seen[req.request_id]),
                              torch.stack(seen_alone[ref.request_id]), atol=1e-6, rtol=1e-5)


def test_a_spilled_and_resumed_request_is_bit_equal_and_nothing_is_reused(params):
    prompt = _prompt(27, 8)

    def serve(spill_at):
        pd = _cluster(params)
        seen = _record(pd)
        d = pd.engines[1]
        req = Request(prompt_tokens=prompt, sampling=SamplingParams(max_new_tokens=8))
        pd.submit(req)
        for _ in range(200):
            if req in d.scheduler.decode.running and req.num_output == spill_at:
                d.scheduler._preempt(req, ScheduleDecision(kind="decode"))
                assert not d.slots.owns(req.request_id) and req.request_id in d.spilled_state
                spill_at = None
            pd.step()
            if req.done:
                break
        # the same prompt again: a prefix hit would need a Mamba-2 state
        again = Request(prompt_tokens=prompt, sampling=SamplingParams(max_new_tokens=2))
        pd.run([again], max_cycles=100)
        return req, torch.stack(seen[req.request_id]), pd

    plain, lg_plain, _ = serve(None)
    spilled, lg_spilled, pd = serve(4)
    assert spilled.output_tokens == plain.output_tokens
    assert torch.equal(lg_spilled, lg_plain)
    assert pd.engines[1].state_spills == 1
    assert pd.stats()["prefix_hits"] == 0 and pd.stats()["prefix_fetches"] == 0
    assert pd.audit_blocks() == 0 and all(e.slots.num_held == 0 for e in pd.engines.values())


def test_a_request_waits_for_a_free_state_slot(params):
    # one slot a node: the second prompt waits on P until the first has
    # moved to D, and on D (in SENDING) until the first has finished
    small = dataclasses.replace(CFG, state_slots=1)
    pd = PDCluster(small, params, num_prefill=1, num_decode=1, num_blocks=64,
                   max_batch_tokens=64, device="cpu")
    reqs = [Request(prompt_tokens=_prompt(n, 9 + n), sampling=SamplingParams(max_new_tokens=4))
            for n in (20, 12)]
    for r in reqs:
        pd.submit(r)
    p, d = pd.engines[0], pd.engines[1]
    pd.step()       # the first prefilled and moved; the second found no slot on P
    assert list(p.scheduler.prefill.waiting) == [reqs[1]] and d.slots.owns(reqs[0].request_id)
    pd.step()       # the second prefilled, but D's one slot is the first's
    assert list(p.scheduler.prefill.sending) == [reqs[1]] and p.slots.owns(reqs[1].request_id)
    pd.run([], max_cycles=200)
    assert all(r.done and r.num_output == 4 for r in reqs)
    one = PDCluster(CFG, params, num_prefill=1, num_decode=1, num_blocks=64,
                    max_batch_tokens=64, device="cpu")
    want = _serve(one, [r.prompt_tokens for r in reqs], new=4)
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in want]
    assert all(e.slots.num_held == 0 and e.state_slots_peak == 1 for e in pd.engines.values())


def test_the_state_copy_is_priced_with_the_pages(params):
    from repro_torch.core.costmodel import select_route
    from repro_torch.core.transfer import PagedStateBackend, backend_for_engine
    pd = _cluster(params)
    p, d = pd.engines[0], pd.engines[1]
    assert isinstance(backend_for_engine(p), PagedStateBackend)
    req, = _serve(pd, [_prompt(30, 11)], new=2)
    rec, = pd.transfers
    # the job's price covers the page plan's calls and bytes plus the copy's
    profile = select_route(False, "gpu")
    assert rec.est_latency_s == profile.latency(rec.num_calls, rec.num_bytes)
    # and the router prices the slot too (the Load-Aware Scheduler reads it)
    cost = pd.controller.model_cost
    assert cost.state_bytes_per_request == CFG.state_slot_bytes()
    nodes = pd.controller.nodes
    with_state = pd.controller._transfer_estimate(nodes[0], nodes[1], req)
    pd.controller.model_cost = dataclasses.replace(cost, state_bytes_per_request=0.0)
    assert with_state > pd.controller._transfer_estimate(nodes[0], nodes[1], req)


@pytest.mark.gpu
def test_the_graph_step_on_the_card_is_the_eager_step():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (H100)")
    # head_dim 64: K4 and K3 have fp32 builds at 64 (the smoke config's 16 is
    # below K4's); three ragged requests, 45 tokens > flash_threshold 40
    cfg = dataclasses.replace(CFG, head_dim=64, attn_scale=1.0 / 64)
    dev = torch.device("cuda", 0)
    file = FAMILY.file_for(cfg)
    params = REF.make_weights(file, SEED, dev)
    prompts = [_prompt(45, 21), _prompt(20, 22), _prompt(33, 23)]
    runs = []
    for graphs in (True, False):
        pd = PDCluster(cfg, params, num_prefill=1, num_decode=1, num_blocks=64,
                       max_batch_tokens=64, device=dev)
        if not graphs:
            for eng in pd.engines.values():
                eng.graphs = None
        seen = _record(pd)
        reqs = _serve(pd, prompts, new=6)
        runs.append((reqs, seen, pd.engines[1].decode_graph_replays))
    (g_reqs, g_seen, replays), (e_reqs, e_seen, _) = runs
    assert replays > 0
    for a, b in zip(g_reqs, e_reqs):
        assert a.output_tokens == b.output_tokens
        assert torch.equal(torch.stack(g_seen[a.request_id]), torch.stack(e_seen[b.request_id]))
        # TF32 off in the reference, fp32 kernels in the port: 1e-4 of ~1e-2
        want = _reference(params, a, file)
        assert torch.allclose(torch.stack(g_seen[a.request_id]), want, atol=1e-4, rtol=1e-3)

