"""The port's optimizer, train step, train-state checkpoint and training
launcher against the reference, float32 on the CPU (qwen3-1.7b smoke,
the reference's weights bridged).

Bars: ``apply_updates`` over 3 steps gives the reference's ``master``,
``m``, ``v``, ``params``, ``grad_norm`` and ``lr`` within 1e-6 (warm-up,
an active clip, bf16 params); ``compress_grads``'s int8 codes and scales
equal the reference's and its residual is within 1e-7
(``tests/test_sharding.py:141-150``); ``zero1_specs`` gives the
reference's specs (``test_sharding.py:80-86``). The train step learns the
copy task in 8 steps (``test_sharding.py::test_train_step_runs_and_learns``,
whose reference step fails under jax 0.9), and after 3 steps its state is
within 1e-5 of ``jax.value_and_grad`` of the reference's loss through the
compute cast plus ``OPT.apply_updates`` (``steps.py:76-95`` without the
sharding constraint), with and without the int8 round trip. The train
checkpoint: ``tests/test_checkpoint.py``'s three tests, and train states
crossing the packages bit for bit, bf16 included. ``launch/train.py
--device cpu`` runs, checkpoints and resumes, with losses within 1e-5 of
the reference's loop on the same init and ``RandomState`` batches.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.distributed import steps as RST  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving import checkpoint as RCK  # noqa: E402
from repro.training import optimizer as ROPT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import steps as ST  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import from_reference, to_numpy, train_state_from_reference  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import checkpoint as CK  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402

ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _close_trees(got, want, atol, rtol=0.0):
    """Every leaf of the port's ``got`` (nested dicts) within tolerance of
    the reference's ``want`` (same structure), leaf order ``jax.tree``'s."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape, i
        np.testing.assert_allclose(to_numpy(a), b, atol=atol, rtol=rtol, err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# apply_updates
# ---------------------------------------------------------------------------
UPDATE_CASES = {
    # warm-up over 10 steps, grads well under the clip
    "warmup": (dict(lr=1e-2, warmup_steps=10), 0.01, jnp.float32),
    # the clip active at every step (grad norm ~ 3 against a clip of 0.5)
    "clip": (dict(lr=1e-2, warmup_steps=1, grad_clip=0.5), 0.3, jnp.float32),
    # bf16 compute params from fp32 masters
    "bf16": (dict(lr=1e-2, warmup_steps=2), 0.05, jnp.bfloat16),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_apply_updates_matches_reference(case):
    kw, gscale, dtype = UPDATE_CASES[case]
    rng = np.random.RandomState(0)
    params_np = {"a": rng.randn(8, 16).astype(np.float32) * 0.1,
                 "layers": {"w": rng.randn(3, 16, 4).astype(np.float32) * 0.1,
                            "norm": np.zeros((3, 16), np.float32)}}
    rparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params_np)
    rstate = ROPT.init_state(rparams)
    state = train_state_from_reference(_np(rstate), device="cpu")
    assert state["params"]["a"].dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                                          else torch.float32)
    rcfg, cfg = ROPT.AdamWConfig(**kw), OPT.AdamWConfig(**kw)
    for step in range(3):
        grads_np = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32) * gscale,
                                params_np)
        rstate, rmet = ROPT.apply_updates(rstate, jax.tree.map(jnp.asarray, grads_np), rcfg,
                                          compute_dtype=dtype)
        state, met = OPT.apply_updates(state, tree_map(torch.from_numpy, grads_np), cfg,
                                       compute_dtype=torch.bfloat16 if dtype == jnp.bfloat16
                                       else torch.float32)
        for key in ("master", "m", "v"):
            _close_trees(state[key], rstate[key], atol=1e-6)
        _close_trees(state["params"], rstate["params"], atol=1e-6)
        assert tree_leaves(state["params"])[0].dtype == tree_leaves(state["master"])[0].dtype \
            or dtype == jnp.bfloat16
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=1e-6, atol=1e-9)
        assert int(state["step"]) == int(rstate["step"]) == step + 1
        assert state["step"].dtype == torch.int32
    if case == "clip":
        assert float(met["grad_norm"]) > kw["grad_clip"]


def test_compress_grads_matches_reference():
    """tests/test_sharding.py:141-150, and the codes and scales equal to the
    reference's on the same grads, over two rounds of error feedback."""
    rng = np.random.RandomState(0)
    grads_np = {"w": rng.randn(8, 8).astype(np.float32),
                "b": {"x": rng.randn(5).astype(np.float32) * 1e-3}}
    params = {"w": np.ones((8, 8), np.float32) * 0.3, "b": {"x": np.zeros(5, np.float32)}}
    ref_ef = ROPT.init_error_feedback(jax.tree.map(jnp.asarray, params))
    ef = OPT.init_error_feedback(tree_map(torch.from_numpy, params))
    for _ in range(2):
        rq, rs, ref_ef = ROPT.compress_grads(jax.tree.map(jnp.asarray, grads_np), ref_ef)
        q, s, ef = OPT.compress_grads(tree_map(torch.from_numpy, grads_np), ef)
        for a, b in zip(tree_leaves(q), jax.tree.leaves(rq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(s), jax.tree.leaves(rs)):
            assert float(a) == float(b)
        _close_trees(ef, ref_ef, atol=1e-7)
    deq = OPT.decompress_grads(q, s)
    g = torch.from_numpy(grads_np["w"])
    err1 = float((deq["w"] - g).abs().max())
    assert err1 < float(g.abs().max()) / 64                # <= the quantisation step


def test_zero1_extends_specs():
    """tests/test_sharding.py:80-86."""
    mesh = SH.AbstractMesh(data=16, model=16)
    shapes = {"w": torch.empty((4096, 16384), device="meta")}
    assert ST.zero1_specs(shapes, {"w": (None, "model")}, mesh)["w"] == ("data", "model")
    mesh = SH.AbstractMesh(pod=2, data=16, model=16)
    assert ST.zero1_specs(shapes, {"w": (None, "model")}, mesh)["w"] == \
        (("pod", "data"), "model")


def test_state_spec_matches_reference_rules():
    """make_train_step's state_spec: TP specs from the logical rules, ZeRO-1
    over data for master / m / v, as the reference's with PartitionSpecs."""
    cfg = get_smoke_config(ARCH)
    mesh = SH.AbstractMesh(data=4, model=2)
    _, spec = ST.make_train_step(get_model(cfg), mesh=mesh)
    rmesh = _FakeMesh((4, 2), ("data", "model"))
    rmodel = ref_get_model(ref_smoke(ARCH))
    rshapes = jax.eval_shape(lambda: rmodel.init(jax.random.PRNGKey(0)))
    from repro.distributed import sharding as RSH

    rp = RSH.tree_specs(rshapes, rmodel.param_axes(), rmesh)
    rz = RST.zero1_specs(rshapes, rp, rmesh)
    for got, want in ((spec["params"], rp), (spec["master"], rz), (spec["m"], rz)):
        g = tree_leaves(tree_map(lambda t: [t], got))
        w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert [tuple(x[0]) if isinstance(x, list) else tuple(x) for x in g] == \
            [tuple(x) for x in w]
    assert spec["step"] == ()


class _FakeMesh:
    """The reference's mesh stand-in of tests/test_sharding.py."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


def test_abstract_train_state_allocates_nothing():
    cfg = get_smoke_config(ARCH)
    st = ST.abstract_train_state(get_model(cfg), with_ef=True)
    assert set(st) == {"params", "master", "m", "v", "step", "ef"}
    assert all(t.device.type == "meta" for t in tree_leaves(st))
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    real = get_model(cfg).init(0, "cpu")
    for a, b in zip(tree_leaves(st["params"]), tree_leaves(real)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert all(t.dtype == torch.float32 for t in tree_leaves(st["master"]))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def _copy_batch(cfg, rng, b=4, s=16):
    toks = rng.randint(0, cfg.vocab_size, (b, s))
    return {"tokens": toks, "labels": toks}


def test_train_step_runs_and_learns():
    """tests/test_sharding.py::test_train_step_runs_and_learns on the port."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    state = OPT.init_state(model.init(0, "cpu"))
    train_step, _ = ST.make_train_step(model, opt_cfg=OPT.AdamWConfig(lr=1e-2, warmup_steps=1))
    batch = {k: torch.from_numpy(v) for k, v in _copy_batch(cfg, np.random.RandomState(0)).items()}
    losses = []
    for _ in range(8):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state["step"]) == 8
    assert not any(t.requires_grad for t in tree_leaves(state))


def _ref_step(model, opt_cfg, compress):
    """steps.py:76-95 without with_sharding_constraint."""
    cfg = model.cfg

    def step(state, batch):
        cast = lambda m: jax.tree.map(lambda w: w.astype(cfg.dtype), m)  # noqa: E731
        loss, grads = jax.value_and_grad(lambda m: model.loss(cast(m), batch))(state["master"])
        if compress:
            q, scales, residual = ROPT.compress_grads(grads, state["ef"])
            grads = ROPT.decompress_grads(q, scales)
            new, met = ROPT.apply_updates({k: v for k, v in state.items() if k != "ef"},
                                          grads, opt_cfg, compute_dtype=cfg.dtype)
            new["ef"] = residual
        else:
            new, met = ROPT.apply_updates(state, grads, opt_cfg, compute_dtype=cfg.dtype)
        met["loss"] = loss
        return new, met

    return jax.jit(step)


# Adam's eps in the train-step comparison. At the default 1e-8 the first
# steps move every master element by about lr * sign(g), so an element whose
# gradient sits at the float32 noise floor (~1e-7 of the leaf's max |g|,
# where the packages' summation orders differ) moves by up to 2 lr between
# them. eps = 1e-4 bounds that to lr * noise / eps; apply_updates holds the
# default eps on identical gradients above.
EPS = 1e-4
STEP_KW = dict(lr=1e-2, warmup_steps=2, eps=EPS)


def _ref_and_port(compress):
    rcfg, cfg = ref_smoke(ARCH), get_smoke_config(ARCH)
    rmodel = ref_get_model(rcfg)
    rstate = ROPT.init_state(rmodel.init(jax.random.PRNGKey(0)))
    if compress:
        rstate["ef"] = ROPT.init_error_feedback(rstate["params"])
    state = train_state_from_reference(_np(rstate), device="cpu")
    rstep = _ref_step(rmodel, ROPT.AdamWConfig(**STEP_KW), compress)
    model = get_model(cfg)
    step, _ = ST.make_train_step(model, opt_cfg=OPT.AdamWConfig(**STEP_KW),
                                 compress_pod_grads=compress)
    return cfg, model, rstate, rstep, state, step


def test_train_step_matches_reference():
    cfg, _, rstate, rstep, state, step = _ref_and_port(False)
    rng = np.random.RandomState(1)
    for _ in range(3):
        b = _copy_batch(cfg, rng, b=2)
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=1e-5)
    assert set(state) == set(rstate)
    for key in state:
        if key != "step":
            _close_trees(state[key], rstate[key], atol=1e-5)
    assert int(state["step"]) == 3


def test_train_step_compressed_matches_reference():
    """compress_pod_grads=True. int8 rounding is discontinuous: an element
    whose scaled gradient lies within the packages' gradient noise of a
    rounding boundary takes the neighbouring code in one of them (once on
    this input, moving a master element by 3.4e-4). So the losses, grad
    norms and lr are held to the reference's own step within 1e-5, and the
    state, after each of 3 steps, to the reference's ``compress_grads`` /
    ``decompress_grads`` / ``apply_updates`` fed the port step's own
    gradient (``ST.loss_and_grads``) within 1e-6."""
    cfg, model, rstate, rstep, state, step = _ref_and_port(True)
    rng = np.random.RandomState(1)
    opt = ROPT.AdamWConfig(**STEP_KW)
    for _ in range(3):
        b = _copy_batch(cfg, rng, b=2)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        _, grads = ST.loss_and_grads(model, state["master"], tb)
        mine = jax.tree.map(jnp.asarray, _np(tree_map(to_numpy, state)))
        q, scales, residual = ROPT.compress_grads(
            jax.tree.map(jnp.asarray, tree_map(to_numpy, grads)), mine["ef"])
        want, _ = ROPT.apply_updates({k: v for k, v in mine.items() if k != "ef"},
                                     ROPT.decompress_grads(q, scales), opt,
                                     compute_dtype=jnp.float32)
        want["ef"] = residual
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=1e-5)
        for key in state:
            if key != "step":
                _close_trees(state[key], want[key], atol=1e-6)
    assert int(state["step"]) == 3 and set(state) == set(rstate)


def test_train_step_bf16_compute_casts_masters():
    """bf16 compute over fp32 masters: the grads are taken w.r.t. the fp32
    masters (fp32), the new params are the masters cast to bf16."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.bfloat16)
    model = get_model(cfg)
    state = OPT.init_state(model.init(0, "cpu"))
    step, _ = ST.make_train_step(model, opt_cfg=OPT.AdamWConfig(lr=1e-2, warmup_steps=1))
    b = {k: torch.from_numpy(v) for k, v in _copy_batch(cfg, np.random.RandomState(0)).items()}
    state, met = step(state, b)
    assert bool(torch.isfinite(met["loss"])) and float(met["grad_norm"]) > 0
    for p, w in zip(tree_leaves(state["params"]), tree_leaves(state["master"])):
        assert p.dtype == torch.bfloat16 and w.dtype == torch.float32
        assert torch.equal(p, w.to(torch.bfloat16))
    assert all(t.dtype == torch.float32 for k in ("m", "v") for t in tree_leaves(state[k]))


# ---------------------------------------------------------------------------
# The train checkpoint: tests/test_checkpoint.py, and across the packages
# ---------------------------------------------------------------------------
def test_train_checkpoint_roundtrip(tmp_path):
    cfg = get_smoke_config("gemma-2b")
    state = OPT.init_state(get_model(cfg).init(0, "cpu"))
    state["step"] = torch.tensor(7, dtype=torch.int32)
    path = CK.save_train_state(state, 7, str(tmp_path))
    assert os.path.exists(path)
    assert CK.latest_checkpoint(str(tmp_path)) == path
    template = ST.abstract_train_state(get_model(cfg))
    restored = CK.load_train_state(template, path, device="cpu")
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    assert int(restored["step"]) == 7


def test_latest_checkpoint_ordering(tmp_path):
    cfg = get_smoke_config("gemma-2b")
    state = OPT.init_state(get_model(cfg).init(0, "cpu"))
    for step in (3, 10, 7):
        CK.save_train_state(state, step, str(tmp_path))
    assert CK.latest_checkpoint(str(tmp_path)).endswith("step_00000010.npz")
    assert CK.latest_checkpoint(str(tmp_path / "nope")) is None
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}.npz" for s in (3, 7, 10)]


def test_bf16_roundtrip(tmp_path):
    state = {"w": torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16),
             "step": torch.tensor(1, dtype=torch.int32)}
    path = CK.save_train_state(state, 1, str(tmp_path))
    assert set(np.load(path).files) == {"w@bf16", "step"}
    restored = CK.load_train_state(state, path)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], state["w"])


def _bf16_ref_state():
    rcfg = dataclasses.replace(ref_smoke(ARCH), dtype=jnp.bfloat16)
    state = ROPT.init_state(ref_get_model(rcfg).init(jax.random.PRNGKey(0)))
    # one update, so m / v / master differ from the params
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), state["params"])
    state, _ = ROPT.apply_updates(state, grads, ROPT.AdamWConfig(), compute_dtype=jnp.bfloat16)
    state["ef"] = jax.tree.map(lambda m: m * 0.5, state["m"])
    return state


def test_reference_train_state_loads_in_the_port(tmp_path):
    rstate = _bf16_ref_state()
    path = RCK.save_train_state(rstate, 1, str(tmp_path))
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.bfloat16)
    template = ST.abstract_train_state(get_model(cfg), with_ef=True)
    state = CK.load_train_state(template, path, device="cpu")
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    g, w = tree_leaves(state), jax.tree.leaves(rstate)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            assert a.dtype == torch.from_numpy(np.array(b)).dtype
            np.testing.assert_array_equal(a.numpy(), b)


def test_port_train_state_loads_in_the_reference(tmp_path):
    rstate = _bf16_ref_state()
    state = train_state_from_reference(_np(rstate), device="cpu")
    path = CK.save_train_state(state, 1, str(tmp_path))
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), rstate)
    back = RCK.load_train_state(template, path)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------
def _ref_train_losses(rcfg, rparams, steps, batch, seq, seed, lr):
    """The reference launcher's loop (train.py:49-76) without its mesh:
    the same RandomState draws, value_and_grad through the cast and
    apply_updates with warmup_steps=10."""
    model = ref_get_model(rcfg)
    state = ROPT.init_state(rparams)
    step = _ref_step(model, ROPT.AdamWConfig(lr=lr, warmup_steps=10), False)
    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(steps):
        toks = jnp.asarray(rng.randint(0, rcfg.vocab_size, (batch, seq)))
        state, met = step(state, {"tokens": toks, "labels": toks})
        losses.append(float(met["loss"]))
    return losses


def test_launcher_matches_reference_loop():
    rcfg, cfg = ref_smoke(ARCH), get_smoke_config(ARCH)
    rparams = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    args = LT.build_parser().parse_args(["--device", "cpu", "--steps", "6", "--batch", "2",
                                         "--seq", "16"])
    lines = []
    _, losses = LT.run(args, params=from_reference(_np(rparams), cfg, device="cpu"),
                       log=lines.append)
    want = _ref_train_losses(rcfg, rparams, 6, 2, 16, 0, args.lr)
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)
    assert [ln.split()[1] for ln in lines] == ["0", "5"]
    assert lines[0].startswith("step     0  loss=") and "gnorm=" in lines[0]


def test_launcher_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    lines = []
    args = LT.build_parser().parse_args(["--device", "cpu", "--steps", "7", "--batch", "2",
                                         "--seq", "8", "--ckpt-dir", ck, "--ckpt-every", "3"])
    state, _ = LT.run(args, log=lines.append)
    assert sorted(os.listdir(ck)) == [f"step_{s:08d}.npz" for s in (3, 6, 7)]
    assert sum(ln.startswith("checkpointed -> ") for ln in lines) == 2
    args.resume, args.steps = True, 2
    lines2 = []
    state2, losses2 = LT.run(args, log=lines2.append)
    assert lines2[0] == f"resumed from {os.path.join(ck, 'step_00000007.npz')} at step 7"
    assert int(state2["step"]) == 9 and len(losses2) == 2
    assert sorted(os.listdir(ck))[-1] == "step_00000009.npz"
    # the resumed run started from the saved state exactly
    saved = CK.load_train_state(state, os.path.join(ck, "step_00000007.npz"))
    for a, b in zip(tree_leaves(saved), tree_leaves(state)):
        assert torch.equal(a, b)
