"""The port's P->D serving path end to end on the CPU (qwen3-1.7b smoke
config, the reference's own weights bridged): a port of
examples/quickstart.py and of test_cluster.py's disaggregated-vs-monolithic
check on 1 prefill + 1 decode node.

Bars: tokens identical to the port's monolithic greedy_generate AND to the
reference's; one transfer dispatch per plan; decode_dispatches ==
decode_steps on the zero-gather path; no leaked blocks; the dense oracle,
chunked prefill and spill/restore give the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.bridge import from_reference  # noqa: E402
from repro_torch.serving.api import FlowKVClient  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.engine import _next_pow2  # noqa: E402
from repro_torch.serving.request import Request, RequestState, SamplingParams  # noqa: E402

STEPS = 6


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_smoke("qwen3-1.7b")
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("qwen3-1.7b")
    params = from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in (12, 25, 33, 40)]
    ref = {}
    for p in prompts:
        want = RT.greedy_generate(rparams, rcfg, jnp.asarray([p], jnp.int32), STEPS)
        got = T.greedy_generate(params, cfg, torch.tensor([p], dtype=torch.int32), STEPS)
        assert got[0].tolist() == [int(x) for x in want[0]]   # port == reference
        ref[tuple(p)] = got[0].tolist()
    return cfg, params, prompts, ref


def _run(cfg, params, prompts, steps=STEPS, **kw):
    kw = {"num_blocks": 64, **kw}
    cluster = PDCluster(cfg, params, num_prefill=1, num_decode=1, device="cpu", **kw)
    reqs = [Request(prompt_tokens=list(p), sampling=SamplingParams(max_new_tokens=steps))
            for p in prompts]
    done = cluster.run(reqs, max_cycles=300)
    assert len(done) == len(prompts)
    return cluster, {tuple(r.prompt_tokens): list(r.output_tokens) for r in done}


def _check_data_plane(cluster):
    s = cluster.stats()
    xfers = [t for t in cluster.transfers if t.kind == "kv"]
    assert xfers and all(t.num_dispatches == 1 and t.status == "ok" for t in xfers)
    assert s["mean_transfer_dispatches"] == 1.0 and s["transfer_retries"] == 0
    assert s["decode_steps"] > 0 and s["decode_dispatches"] == s["decode_steps"]
    for r in cluster.finished:
        assert r.decode_dispatches == r.decode_steps
        assert r.transfer_dispatches == 1
    cluster.assert_no_leaks()
    for eng in cluster.engines.values():
        eng.scheduler.bm.check_invariants()
        assert eng.scheduler.bm.free_capacity == eng.scheduler.bm.num_blocks
    assert s["leaked_blocks"] == 0.0


def test_quickstart_streams_token_identical(setup):
    """examples/quickstart.py on the port: streamed tokens == monolithic."""
    cfg, params, prompts, ref = setup
    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1, num_blocks=128,
                          transfer_schedule="flowkv", device="cpu")
    handles = [client.submit(p, SamplingParams(max_new_tokens=STEPS)) for p in prompts[:3]]
    for h in handles:
        assert list(h.tokens()) == ref[tuple(h.request.prompt_tokens)]
        t = h.stats()
        assert t["state"] == RequestState.FINISHED.value
        assert t["decode_steps"] == t["decode_dispatches"] > 0
    s = client.stats()
    assert s["transfers"] == 3 and s["mean_transfer_calls"] == 1.0
    _check_data_plane(client.cluster)


@pytest.mark.parametrize("schedule", ["flowkv", "layerwise", "blockwise"])
def test_disaggregated_matches_monolithic(setup, schedule):
    cfg, params, prompts, ref = setup
    cluster, outs = _run(cfg, params, prompts, num_blocks=128, transfer_schedule=schedule)
    assert outs == ref
    _check_data_plane(cluster)
    if schedule == "flowkv":
        assert cluster.stats()["mean_transfer_calls"] == 1.0


def test_dense_oracle_token_identical(setup):
    cfg, params, prompts, ref = setup
    cluster, outs = _run(cfg, params, prompts, paged_decode="dense")
    assert outs == ref
    d = cluster.engines[1]
    assert d.decode_dispatches >= 3 * d.decode_steps          # 2B+1 per dense step
    cluster.assert_no_leaks()


def test_chunked_prefill_token_identical(setup):
    """A 16-token cycle budget chunks every prompt: suffix chunks attend over
    the pages earlier chunks wrote."""
    cfg, params, prompts, ref = setup
    cluster, outs = _run(cfg, params, prompts, max_batch_tokens=16,
                         prefill_chunk_tokens=16)
    assert outs == ref
    assert cluster.stats()["prefill_tokens_computed"] == sum(len(p) for p in prompts)
    _check_data_plane(cluster)


def test_spill_and_restore_token_identical(setup):
    """A 3-block pool forces a decode request out (KV spilled host-side)
    and back in; generation stays token-identical."""
    cfg, params, _, _ = setup
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab_size, size=20).tolist() for _ in range(2)]
    cluster = PDCluster(cfg, params, num_prefill=1, num_decode=1, num_blocks=3,
                        device="cpu")
    reqs = [Request(prompt_tokens=p, sampling=SamplingParams(max_new_tokens=20))
            for p in prompts]
    for r in reqs:
        cluster.submit(r)
    swapped = False
    for _ in range(400):
        cluster.step()
        swapped |= any(r.state is RequestState.SWAPPED for r in reqs)
        if all(r.state is RequestState.FINISHED for r in reqs):
            break
    assert swapped and all(r.state is RequestState.FINISHED for r in reqs)
    for r in reqs:
        want = T.greedy_generate(params, cfg, torch.tensor([r.prompt_tokens],
                                                           dtype=torch.int32), 20)
        assert r.output_tokens == want[0].tolist()
    cluster.assert_no_leaks()


def test_freelist_allocator_costs_more_transfer_calls(setup):
    cfg, params, prompts, ref = setup
    calls = {}
    for alloc in ("flowkv", "freelist"):
        cluster, outs = _run(cfg, params, prompts, steps=3, allocator=alloc)
        calls[alloc] = cluster.stats()["mean_transfer_calls"]
        assert all(o == ref[p][:3] for p, o in outs.items())
    assert calls["flowkv"] <= calls["freelist"]


def test_decode_buckets_are_powers_of_two(setup):
    cfg, params, prompts, _ = setup
    cluster, _ = _run(cfg, params, prompts[:3], steps=4)
    keys = cluster.engines[1]._decode_cache_keys
    assert keys and all(b == _next_pow2(b) and w == _next_pow2(w) for b, w in keys)
    assert cluster.stats()["decode_compile_variants"] == len(keys)
