"""RoPE's frequencies without a host copy, and the paged decode step
replayed from a CUDA graph per (lanes, width) bucket
(``serving/decode_graphs.py``).

On the CPU: the cached frequencies equal the formula they replace bit for
bit, are built once per (head_dim, theta, device), ``meta`` included, and
serve autograd after a build under ``inference_mode``; which engines may
capture; a CPU engine never does (its replays stay 0 and its traced steps
say ``graph == "eager"``).

On the card (``gpu`` marker; every test skips without an sm_90 device): a
replayed step's logits and pool bytes equal the eager ``Model.decode_paged``
bit for bit at buckets (1, 2), (16, 512) and (32, 512) with pad lanes, over
successive replays with other tokens, lengths and tables; the kernel
wrappers count the host's calls (a capture's twice the eager step's, a
replay's none) and the profiler records each kernel of a replay; a graph
refuses another pool; engines take the graph where they can, and a served
smoke cluster gives the same tokens and the same K3 and K1 device records
with and without graphs. The module imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_decode_graphs.py
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.models import api as API  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.obs.tracing import attach_tracer  # noqa: E402
from repro_torch.serving.cluster import PDCluster  # noqa: E402
from repro_torch.serving.decode_graphs import DecodeGraphs  # noqa: E402
from repro_torch.serving.engine import NodeEngine  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams  # noqa: E402


# the profiler keeps only the records inside its window, and the device's
# clock may run tens of ms from the host's: idle before and after the work
PROFILE_PAD_S = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _old_rope_freqs(head_dim, theta, device):
    """The formula as it stood: a host copy of ``theta`` every call."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


class _Ops(TorchDispatchMode):
    """The aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (64, 10000.0), (128, 1000000.0),
                                            (128, 500000.0), (160, 10000.0), (256, 10000)])
def test_rope_freqs_equal_the_old_formula_bit_for_bit(head_dim, theta):
    got = C.rope_freqs(head_dim, theta, torch.device("cpu"))
    want = _old_rope_freqs(head_dim, theta, "cpu")
    assert got.dtype == torch.float32 and got.shape == (head_dim // 2,)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x = torch.randn((2, 5, 3, head_dim), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(7, 17).reshape(2, 5)
    angles = pos[..., :, None].float() * want
    cos, sin = torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    old = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    assert torch.equal(C.apply_rope(x, pos, theta).view(torch.int32), old.view(torch.int32))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_rope_freqs_are_built_once_per_head_dim_theta_and_device(device):
    theta = 123457.0 + (device == "meta")          # a key no other test builds
    x = torch.zeros((1, 4, 2, 32), device=device)
    pos = torch.zeros((1, 4), dtype=torch.int64, device=device)
    with _Ops() as first:
        C.apply_rope(x, pos, theta)
    with _Ops() as again:
        C.apply_rope(x, pos, theta)
        C.apply_rope(x, pos, theta)
    # the build (arange, div, theta's copy, pow, reciprocal) runs once; each
    # later call runs only the rotation
    rotation = first.names[first.names.index("unsqueeze"):]
    assert "pow" in first.names and "pow" not in rotation
    assert again.names == 2 * rotation
    f = C.rope_freqs(32, theta, torch.device(device))
    assert f is C.rope_freqs(32, theta, torch.device(device))
    assert f.device.type == device and f.shape == (16,)
    assert f is not C.rope_freqs(32, theta + 1.0, torch.device(device))
    assert f is not C.rope_freqs(16, theta, torch.device(device))
    assert C.rope_freqs(32, theta, torch.device("meta" if device == "cpu" else "cpu")) \
        .device.type != device


def test_rope_built_under_inference_mode_serves_autograd():
    theta = 7777.0
    with torch.inference_mode():
        C.apply_rope(torch.ones((1, 2, 1, 8)), torch.arange(2)[None], theta)
    freqs = C.rope_freqs(8, theta, torch.device("cpu"))
    assert not freqs.is_inference() and not freqs.requires_grad
    x = torch.randn((1, 3, 2, 8), requires_grad=True)
    C.apply_rope(x, torch.arange(3)[None], theta).square().sum().backward()
    # the rotation keeps norms, so d/dx sum(rope(x)^2) = 2x
    assert torch.allclose(x.grad, 2 * x.detach(), atol=1e-5)


# ---------------------------------------------------------------------------
# Who takes the graph
# ---------------------------------------------------------------------------
def test_which_forwards_have_static_shapes():
    """Every paged family's step but the top-1 sparse MoE dispatch's, which
    reads expert ids on the host; the state families have no paged step."""
    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                 "llava-next-34b", "gemma-2b"):
        assert API.get_model(get_smoke_config(arch)).decode_paged_static, arch
    sparse = dataclasses.replace(get_smoke_config("llama4-scout-17b-a16e"),
                                 moe_sparse_dispatch=True)
    assert not API.get_model(sparse).decode_paged_static
    for arch in ("mamba2-370m", "recurrentgemma-2b"):
        model = API.get_model(get_smoke_config(arch))
        assert model.decode_paged is None and not model.decode_paged_static, arch


def _requests(cfg, seed=3):
    rng = np.random.RandomState(seed)
    return [Request(prompt_tokens=rng.randint(0, cfg.vocab_size, size=n).tolist(),
                    sampling=SamplingParams(max_new_tokens=m))
            for n, m in ((20, 6), (45, 4), (33, 7), (70, 5))]


def test_a_cpu_engine_replays_no_graph():
    cfg = get_smoke_config("qwen3-1.7b")
    model = API.get_model(cfg)
    cluster = PDCluster(cfg, model.init(0, "cpu"), num_prefill=1, num_decode=1,
                        num_blocks=64, device="cpu")
    rec = attach_tracer(cluster)
    assert len(cluster.run(_requests(cfg), max_cycles=200)) == 4
    steps = rec.by_name("decode_step")
    assert steps and {s.attrs["graph"] for s in steps} == {"eager"}
    for eng in cluster.engines.values():
        assert eng.graphs is None
        assert eng.decode_graph_captures == eng.decode_graph_replays == 0
    assert sum(e.decode_steps for e in cluster.engines.values()) == len(steps)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _require_sm90():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (H100)")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _step_inputs(rng, lanes, real, width, nb, bs, vocab):
    """One padded step: each real lane's pages distinct blocks (so the
    appends never race), lane 0 filling the whole table where it is wide,
    pad lanes copying lane 0, as the engine pads."""
    room = width * bs - 1
    lens = rng.integers(1, min(4000, room), size=real)
    if width > 2:
        lens[0] = room - int(rng.integers(0, bs))
    need = lens // bs + 1
    perm = rng.permutation(nb)
    tables = np.zeros((lanes, width), np.int32)
    off = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[off:off + n]
        off += n
    assert off <= nb
    toks = rng.integers(0, vocab, size=real)
    tables[real:] = tables[0]
    tok_arr = np.full(lanes, toks[0], np.int32)
    tok_arr[:real] = toks
    len_arr = np.full(lanes, lens[0], np.int32)
    len_arr[:real] = lens
    return tok_arr, tables, len_arr


@pytest.fixture(scope="module")
def qwen_four_layers():
    """Full-width qwen3-1.7b bf16 cut to 4 layers, on the card, and a pool
    of 4096 blocks of random K/V."""
    _require_sm90()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=4)
    model = API.get_model(cfg)
    params = model.init(0, "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    payload = cfg.block_size * cfg.num_kv_heads * cfg.head_dim
    pool = torch.randn((4096, cfg.num_layers, 2, payload), generator=g,
                       device="cuda").to(cfg.dtype)
    yield cfg, model, params, pool
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,real,width", [(1, 1, 2), (16, 16, 512), (32, 21, 512)])
def test_a_replayed_step_is_bit_identical_to_the_eager_step(qwen_four_layers, lanes, real,
                                                            width):
    _require_sm90()
    cfg, model, params, pool0 = qwen_four_layers
    eager_pool, graph_pool = pool0.clone(), pool0.clone()
    graphs = DecodeGraphs(torch.device("cuda", 0), cfg.num_kv_heads)
    rng = np.random.default_rng([lanes, width])
    for step in range(3):           # the capture, then two replays on other inputs
        arrs = _step_inputs(rng, lanes, real, width, pool0.shape[0], cfg.block_size,
                            cfg.vocab_size)
        tok, bt, lens = (torch.from_numpy(a).cuda() for a in arrs)
        reset_launch_counts()
        want, _ = model.decode_paged(params, tok, eager_pool, bt, lens)
        eager_counts = launch_counts()
        assert eager_counts["paged_decode_attention"] == cfg.num_layers
        assert eager_counts["kv_transfer"] == 1
        reset_launch_counts()
        got, how = graphs.run(graphs.stage(*arrs), model.decode_paged, params, graph_pool)
        assert how == ("capture" if step == 0 else "replay"), step
        # the wrappers count the host's calls: the eager step and the
        # capture's recorded one, then none for a replay
        assert launch_counts() == {k: 2 * n if step == 0 else 0
                                   for k, n in eager_counts.items()}, step
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), step
        assert torch.equal(_bits(graph_pool), _bits(eager_pool)), step
    assert (graphs.captures, graphs.replays) == (1, 2)


@pytest.mark.gpu
def test_the_profiler_records_each_kernel_of_a_replay(qwen_four_layers):
    """The benchmark's device metrics read the profiler's raw records: a
    replay must show each of its K3 launches and its K1 append as one."""
    _require_sm90()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, model, params, pool0 = qwen_four_layers
    pool = pool0.clone()
    graphs = DecodeGraphs(torch.device("cuda", 0), cfg.num_kv_heads)
    arrs = _step_inputs(np.random.default_rng(9), 8, 6, 64, pool0.shape[0],
                        cfg.block_size, cfg.vocab_size)
    assert graphs.run(graphs.stage(*arrs), model.decode_paged, params, pool)[1] == "capture"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(3):
            assert graphs.run(graphs.stage(*arrs), model.decode_paged, params,
                              pool)[1] == "replay"
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    assert sum("paged_decode" in n for n in names) == 3 * cfg.num_layers, names
    assert sum("kv_transfer" in n for n in names) == 3, names


@pytest.mark.gpu
def test_a_graph_refuses_another_pool_or_params(qwen_four_layers):
    _require_sm90()
    cfg, model, params, pool0 = qwen_four_layers
    graphs = DecodeGraphs(torch.device("cuda", 0), cfg.num_kv_heads)
    rng = np.random.default_rng(5)
    a, b = pool0.clone(), pool0.clone()
    arrs = _step_inputs(rng, 4, 3, 64, pool0.shape[0], cfg.block_size, cfg.vocab_size)
    hows = [graphs.run(graphs.stage(*arrs), model.decode_paged, params, a)[1]
            for _ in range(2)]
    assert hows == ["capture", "replay"]
    for other in ((params, b), (dict(params), a)):
        with pytest.raises(RuntimeError, match="differ from those it captured"):
            graphs.run(graphs.stage(*arrs), model.decode_paged, *other)
    # another pool takes graphs of its own
    fresh = DecodeGraphs(torch.device("cuda", 0), cfg.num_kv_heads)
    tok, bt, lens = (torch.from_numpy(x).cuda() for x in arrs)
    want, _ = model.decode_paged(params, tok, b.clone(), bt, lens)
    got, how = fresh.run(fresh.stage(*arrs), model.decode_paged, params, b)
    torch.cuda.synchronize()
    assert how == "capture" and torch.equal(_bits(got), _bits(want))
    assert (graphs.captures, graphs.replays) == (1, 1)


@pytest.mark.gpu
def test_engines_take_the_graph_where_they_can():
    _require_sm90()
    cfg = get_smoke_config("qwen3-1.7b")

    def engine(cfg=cfg, **kw):
        model = API.get_model(cfg)
        return NodeEngine(0, cfg, model.init(0, "cuda"), num_blocks=16, device="cuda", **kw)

    assert engine().graphs is not None
    assert engine(paged_decode="kernel").graphs is not None
    assert engine(get_smoke_config("granite-moe-1b-a400m")).graphs is not None
    assert engine(paged_decode="dense").graphs is None
    assert engine(tp_degree=2).graphs is None
    assert engine(dataclasses.replace(get_smoke_config("llama4-scout-17b-a16e"),
                                      moe_sparse_dispatch=True)).graphs is None
    assert engine(get_smoke_config("mamba2-370m")).graphs is None
    assert NodeEngine(0, cfg, API.get_model(cfg).init(0, "cpu"), num_blocks=16,
                      device="cpu").graphs is None


@pytest.mark.gpu
def test_a_served_cluster_gives_the_eager_tokens_and_launches():
    """The same prompts served by a smoke 1P+1D cluster on the card with
    the engines' graphs and with them taken away: equal tokens, equal
    step counters, and the device records of K3 and of K1's kernels equal
    (layers a step for K3); the wrappers count the host's calls, so the
    graphs' run counts twice a capture's step and nothing for a replay.
    Traced steps say how they ran."""
    _require_sm90()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_smoke_config("qwen3-1.7b")
    params = API.get_model(cfg).init(0, "cuda")
    runs = {}
    for graphs in (True, False):
        cluster = PDCluster(cfg, params, num_prefill=1, num_decode=1, num_blocks=64,
                            device="cuda")
        if not graphs:
            for eng in cluster.engines.values():
                eng.graphs = None
        rec = attach_tracer(cluster)
        reqs = _requests(cfg)
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            assert len(cluster.run(reqs, max_cycles=200)) == 4
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        engs = cluster.engines.values()
        runs[graphs] = ([r.output_tokens for r in reqs], launch_counts(),
                        (sum("paged_decode" in n for n in names),
                         sum("kv_transfer" in n for n in names)),
                        tuple(sum(getattr(e, k) for e in engs)
                              for k in ("decode_steps", "decode_dispatches")),
                        [s.attrs["graph"] for s in rec.by_name("decode_step")],
                        tuple(sum(getattr(e, k) for e in engs)
                              for k in ("decode_graph_captures", "decode_graph_replays")))
    (tok_g, cnt_g, dev_g, steps_g, how_g, cap_g), \
        (tok_e, cnt_e, dev_e, steps_e, how_e, cap_e) = runs[True], runs[False]
    assert tok_g == tok_e and dev_g == dev_e and steps_g == steps_e
    assert dev_e[0] == cnt_e["paged_decode_attention"] == steps_e[0] * cfg.num_layers
    assert dev_e[1] == cnt_e["kv_transfer"] + cnt_e["kv_scatter"]
    assert cnt_g["paged_decode_attention"] == 2 * cap_g[0] * cfg.num_layers
    assert set(how_e) == {"eager"} and cap_e == (0, 0)
    assert how_g.count("capture") == cap_g[0] and how_g.count("replay") == cap_g[1] > 0
    assert cap_g[0] + cap_g[1] == len(how_g)
