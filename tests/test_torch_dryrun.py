"""The port's dry-run accounting (``launch/dryrun.py``, ``op_counts.py``,
``analysis.py``, ``mesh.py`` and the helpers it reads) against the
reference, on the CPU.

Bars:

* ``ASSIGNED_ARCHS``, ``SHAPES`` and ``list_cells()`` equal the reference's.
* For every applicable (arch, shape) cell at full size, ``input_specs``
  equals the reference's: tree structure, shapes, dtypes and logical axes
  (``tests/test_sharding.py::test_input_specs_all_cells`` made a parity
  test); ``bytes_per_device`` of the cell's resident state (params for
  prefill, params + cache for decode, the train state under ``state_spec``
  for train) equals the reference's ``SH.bytes_per_device`` over its own
  ``AbstractMesh``, as exact integers, on both production meshes.
* ``kv_transfer_specs`` shapes equal the reference's for every arch, and
  the transfer cell's plan equals the reference's ``TransferPlanner`` plan.
* The op counter counts 3 x 7 matmuls of 128 x 128 as exactly 2 * 128^3 *
  21 FLOPs (``test_system.py::test_hlo_flops_counts_nested_scans``) and an
  elementwise function as 0; a loop run once by ``trips`` counts what the
  whole loop counts, FLOPs and bytes.
* Smoke qwen3-1.7b: the prefill's count equals the reference's analytic
  ``prefill_flops`` less what that count takes for the embedding lookup,
  which is a gather and no matmul: 2 * vocab * d_model a token, less the
  one head matmul a prefill does (the last position's logits). So the
  count is exactly ``analytic - 2 * V * d * (T - 1)``, within 8.3% (T=64)
  and 5.6% (T=256) of it. A train step counts 3x its loss's forward
  (backward: two matmuls for each forward one; AdamW counts 0), within
  1%; under remat "full" between 3.5x and 4x: each layer's forward runs
  again, up to the last tensor its backward needs (``torch.utils.
  checkpoint`` stops there, before the MLP's down projection). A decode
  step counts exactly 2 * N * B plus the attention over the whole cache
  (4 * L * H * hd * B * T).
* The top-1 sparse MoE on ``meta`` prices all B * S tokens through one
  expert (its routing is data). Above ``flash_threshold`` a prefill runs
  K4, stablelm-12b's head dim 160 too; a head dim K4 does not take raises
  on ``meta`` as on the card.
* K4 on ``meta`` returns its output's shape and reports exactly its causal
  count; K4 and K3 still raise on a device they do not take and still run
  the plain version on the CPU.
* ``python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape
  decode_32k --mesh single`` exits 0 in a subprocess, without importing
  JAX, and its record has the reference record's keys; ``--mesh both``
  traces an (arch, shape) once for its two meshes.
"""
import dataclasses
import functools
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.core.transfer import TransferPlanner as RTransferPlanner  # noqa: E402
from repro.core.layout import KVCacheSpec as RKVCacheSpec  # noqa: E402
from repro.distributed import sharding as RSH  # noqa: E402
from repro.distributed import steps as RST  # noqa: E402
from repro.launch.hlo_analysis import Roofline as RRoofline  # noqa: E402
from repro.models import api as RAPI  # noqa: E402
from repro.obs import calibrate as RCAL  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import steps as ST  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill_op, flash_prefill_ref  # noqa: E402
from repro_torch.kernels.flash_prefill.ops import flops as k4_flops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402
from repro_torch.launch import analysis as AN  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import op_counts as OC  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import api as API  # noqa: E402
from repro_torch.models.flash import flash_attention  # noqa: E402
from repro_torch.obs import calibrate as CAL  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": dict(data=16, model=16), "multi": dict(pod=2, data=16, model=16)}
APPLICABLE = [(c["arch"], c["shape"]) for c in RC.list_cells() if c["applicable"]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor) \
        else np.dtype(x.dtype).name


def _same_tree(port, ref, where=""):
    """Equal structure, shapes and dtypes (leaves) or equal axes tuples."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (where, sorted(port), sorted(ref))
        for k in ref:
            _same_tree(port[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, tuple):
        assert tuple(port) == ref, (where, port, ref)
    else:
        assert isinstance(port, torch.Tensor) and port.device.type == "meta", where
        assert tuple(port.shape) == tuple(ref.shape), (where, port.shape, ref.shape)
        assert _dtype(port) == _dtype(ref), (where, port.dtype, ref.dtype)


# ---------------------------------------------------------------------------
# Cells, input specs and resident bytes against the reference
# ---------------------------------------------------------------------------
def test_cells_equal_the_reference():
    assert C.ASSIGNED_ARCHS == RC.ASSIGNED_ARCHS
    assert C.SHAPES == RC.SHAPES
    assert C.list_cells() == RC.list_cells()
    assert C.list_cells(["qwen3-1.7b", "mamba2-370m"]) == RC.list_cells(["qwen3-1.7b",
                                                                         "mamba2-370m"])
    assert API.ENC_MEMORY_LEN == RAPI.ENC_MEMORY_LEN
    for multi, sizes in ((False, MESHES["single"]), (True, MESHES["multi"])):
        assert make_production_mesh(multi_pod=multi).shape == sizes
    assert make_local_mesh(2, 4, 2).shape == {"pod": 2, "data": 2, "model": 4}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = RAPI.get_model(RC.get_config(arch))
    return model, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", RC.ASSIGNED_ARCHS)
def test_input_specs_equal_the_reference(arch):
    cfg, rcfg = C.get_config(arch), RC.get_config(arch)
    for a, shape in APPLICABLE:
        if a != arch:
            continue
        kind, seq, batch = C.SHAPES[shape]
        specs, axes = API.input_specs(cfg, kind, seq, batch)
        rspecs, raxes = RAPI.input_specs(rcfg, kind, seq, batch)
        _same_tree(specs, rspecs, f"{arch}/{shape}")
        _same_tree(axes, raxes, f"{arch}/{shape} axes")


def _ref_resident(arch, kind, seq, batch, amesh) -> int:
    model, params = _ref_params(arch)
    p_spec = RSH.tree_specs(params, model.param_axes(), amesh)
    if kind == "train":
        state = RST.abstract_train_state(model)
        z = RST.zero1_specs(params, p_spec, amesh)
        spec = {"params": p_spec, "master": z, "m": z, "v": z, "step": RSH.scalar_spec()}
        return RSH.bytes_per_device(state, spec, amesh)
    resident = RSH.bytes_per_device(params, p_spec, amesh)
    if kind == "decode":
        specs, axes = RAPI.input_specs(RC.get_config(arch), "decode", seq, batch)
        resident += RSH.bytes_per_device(
            specs["cache"], RSH.tree_specs(specs["cache"], axes["cache"], amesh), amesh)
    return resident


@pytest.mark.parametrize("arch", RC.ASSIGNED_ARCHS)
def test_bytes_per_device_equal_the_reference(arch):
    cfg = C.get_config(arch)
    for a, shape in APPLICABLE:
        if a != arch:
            continue
        kind, seq, batch = C.SHAPES[shape]
        for name, sizes in MESHES.items():
            mesh = make_production_mesh(multi_pod=name == "multi")
            _, _, resident, _ = D.cell_state(cfg, kind, seq, batch, mesh)
            want = _ref_resident(arch, kind, seq, batch, RSH.AbstractMesh(**sizes))
            assert isinstance(resident, int) and resident == want, (arch, shape, name)


def test_tree_shardings_and_scalar_spec():
    mesh = make_production_mesh()
    shapes = {"w": torch.empty((4096, 2048), device="meta"),
              "s": torch.empty((), device="meta")}
    axes = {"w": ("mlp", "embed"), "s": ()}
    sh = SH.tree_shardings(shapes, axes, mesh)
    assert sh["w"] == SH.Sharding(mesh, ("model",)) and sh["s"].spec == SH.scalar_spec() == ()
    specs = {k: v.spec for k, v in sh.items()}
    assert SH.bytes_per_device(shapes, specs, mesh) == 4096 * 2048 * 4 // 16 + 4


@pytest.mark.parametrize("arch", RC.ASSIGNED_ARCHS)
def test_kv_transfer_specs_equal_the_reference(arch):
    spec, pspec = ST.kv_transfer_specs(C.get_config(arch), make_production_mesh(multi_pod=True),
                                       seq=32768, batch=128)
    rspec, rpspec = RST.kv_transfer_specs(RC.get_config(arch), None, seq=32768, batch=128)
    assert tuple(spec.shape) == tuple(rspec.shape) and _dtype(spec) == _dtype(rspec)
    assert spec.device.type == "meta" and pspec == tuple(rpspec) == ("pod",)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_transfer_cell_plans_as_the_reference(arch):
    rec = D._transfer_cell(arch)
    cfg = RC.get_config(arch)
    spec = RKVCacheSpec(num_layers=cfg.num_attention_layers(),
                        num_blocks=128 * -(-32768 // cfg.block_size), block_size=cfg.block_size,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, dtype=cfg.dtype)
    blocks = list(range(spec.num_blocks))
    plan = RTransferPlanner(spec).plan_flowkv(blocks, blocks)
    assert rec["status"] == "ok" and rec["plan"]["num_calls"] == plan.num_calls
    assert rec["plan"]["total_bytes"] == plan.total_bytes == rec["pool_bytes_global"]
    assert rec["plan"]["num_blocks"] == plan.num_blocks
    assert rec["plan"]["shard_pair_dispatches"]["tp1->tp1"] == 1
    k1 = rec["op_counts"]["kernels"]["kv_transfer"]      # one K1 launch: read + write
    pages = plan.num_blocks * cfg.num_attention_layers() * 2
    assert k1["launches"] == 1 and k1["bytes"] == 2 * plan.total_bytes + 8 * pages


# ---------------------------------------------------------------------------
# The op counter
# ---------------------------------------------------------------------------
def test_op_counter_counts_nested_loops_and_no_elementwise_flops():
    a = torch.zeros((128, 128), device="meta")

    def f(x):
        for _ in range(3):
            for _ in range(7):
                x = x @ a
        return x

    _, c = OC.count(f, torch.zeros((128, 128), device="meta"))
    assert c.flops == 2 * 128 ** 3 * 21 and c.unknown_trip_counts == 0
    assert dict(c.flops_by_op) == {"mm": 2 * 128 ** 3 * 21}
    assert c.bytes == 21 * 3 * 128 * 128 * 4            # two operands read, one written
    assert c.peak_bytes == 2 * 128 * 128 * 4            # x and x @ a live together
    _, c = OC.count(lambda x: (x * 2 + 1).exp(), torch.zeros(1000, device="meta"))
    assert c.flops == 0 and c.bytes == 3 * 2 * 4000
    # real tensors count the same; views move nothing; a scatter moves its values
    out, c = OC.count(f, torch.ones((128, 128)))
    assert c.flops == 2 * 128 ** 3 * 21 and out.device.type == "cpu"
    x, y = torch.zeros(1000, device="meta"), torch.zeros(10, 100, device="meta")
    assert OC.count(lambda: x.view(10, 100).t())[1].bytes == 0
    assert OC.count(lambda: x.copy_(y.view(-1)))[1].bytes == 8000
    assert OC.count(lambda: x.add_(y.view(-1)))[1].bytes == 12000


def test_trips_counts_what_the_whole_loop_counts():
    """The chunked flash attention of a prefill and mamba2's SSD scan run one
    pass of their loops on meta; a loop autograd records runs them all."""
    from repro_torch.models import mamba2

    q = torch.empty((2, 300, 4, 16), device="meta")
    k = torch.empty((2, 300, 2, 16), device="meta")

    def counted(grad):
        qq = q.clone().requires_grad_(grad)
        return OC.count(lambda: flash_attention(qq, k, k, q_chunk=64, kv_chunk=128))

    (o1, c1), (o2, c2) = counted(False), counted(True)
    assert o1.shape == o2.shape == q.shape
    assert c1.ops < c2.ops and (c1.flops, c1.bytes) == (c2.flops, c2.bytes) and c1.flops > 0

    args = [torch.empty(s, device="meta") for s in
            ((2, 200, 4), (2, 200, 8), (2, 200, 8), (2, 200, 4, 16), (2, 4, 16, 8))]

    def ssd(grad):
        a = [x.clone().requires_grad_(grad) for x in args]
        return OC.count(lambda: mamba2._ssd_chunked(*a, chunk=64))

    (y1, c1), (y2, c2) = ssd(False), ssd(True)
    assert y1[0].shape == y2[0].shape == (2, 200, 4, 16)
    assert c1.ops < c2.ops and (c1.flops, c1.bytes) == (c2.flops, c2.bytes) and c1.flops > 0


def _smoke(arch="qwen3-1.7b", **over):
    cfg = dataclasses.replace(C.get_smoke_config(arch), **over)
    return cfg, API.get_model(cfg)


@pytest.mark.parametrize("tokens", [64, 256])
def test_prefill_count_agrees_with_the_analytic_count(tokens):
    cfg, model = _smoke()
    params = model.init(0, "meta")
    batch = {"tokens": torch.zeros((1, tokens), dtype=torch.int32, device="meta")}
    _, c = OC.count(model.prefill, params, batch)
    analytic = RCAL.prefill_flops(RC.get_smoke_config("qwen3-1.7b"), tokens)
    embed_term = 2 * cfg.vocab_size * cfg.d_model * (tokens - 1)
    assert c.flops == analytic - embed_term
    assert abs(c.flops - analytic) / analytic <= {64: 0.083, 256: 0.056}[tokens]
    # the port's prefill_flops: the analytic floor, refined upward only
    assert CAL.prefill_flops(cfg, tokens) == analytic
    assert CAL.prefill_flops(cfg, tokens, c) == analytic
    more = OC.OpCounts(flops=int(analytic) + 5)
    assert CAL.prefill_flops(cfg, tokens, more) == analytic + 5


@pytest.mark.parametrize("remat,band", [("none", (2.97, 3.03)), ("full", (3.5, 4.0))])
def test_train_count_is_a_multiple_of_the_forward(remat, band):
    cfg, model = _smoke(remat=remat)
    specs, _ = API.input_specs(cfg, "train", 64, 2)
    _, fwd = OC.count(model.loss, model.init(0, "meta"), specs)
    run, inputs, _, _ = D.cell_state(cfg, "train", 64, 2, make_local_mesh())
    _, train = OC.count(run)
    assert band[0] <= train.flops / fwd.flops <= band[1], train.flops / fwd.flops


def test_decode_count_is_the_weights_plus_the_cache():
    cfg, _ = _smoke()
    b, t = 3, 96
    run, _, resident, _ = D.cell_state(cfg, "decode", t, b, make_local_mesh())
    _, c = OC.count(run)
    attn = 4 * cfg.num_layers * cfg.num_heads * cfg.head_dim * b * t
    assert c.flops == 2 * cfg.active_params() * b + attn


def test_prefill_takes_k4_only_where_k4_takes_the_head_shape():
    """Above flash_threshold, serving attention is K4, at stablelm-12b's
    head dim 160 too; a head dim K4 does not take raises on meta, as it
    does on the card (there is no fallback to the chunked flash.py)."""
    batch = {"tokens": torch.zeros((1, 40), dtype=torch.int32, device="meta")}
    for hd in (16, 160):
        cfg, model = _smoke("stablelm-12b", head_dim=hd, flash_threshold=16)
        _, c = OC.count(model.prefill, model.init(0, "meta"), batch)
        assert c.kernels["flash_prefill"]["launches"] == cfg.num_layers, hd
        assert "bmm" not in c.flops_by_op, hd
    cfg, model = _smoke("stablelm-12b", head_dim=96, flash_threshold=16)
    with pytest.raises(ValueError, match="kernel supports hd"):
        OC.count(model.prefill, model.init(0, "meta"), batch)


def test_top1_sparse_moe_counts_every_token_through_one_expert_on_meta():
    """Its routing is data: on meta the B*S tokens run as one group; on the
    CPU the plain grouping by expert (and its host sync) stays."""
    from repro_torch.models import moe

    cfg = C.get_smoke_config("llama4-scout-17b-a16e")
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    rng = np.random.RandomState(0)
    p = {"router": rng.randn(d, e), "w_gate": rng.randn(e, d, f) / 8,
         "w_up": rng.randn(e, d, f) / 8, "w_down": rng.randn(e, f, d) / 8}
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    x = torch.from_numpy(rng.randn(2, 24, d).astype(np.float32))
    (out, _), c = OC.count(moe.moe_ffn_topk_sparse, {k: v.to("meta") for k, v in p.items()},
                           x.to("meta"), cfg)
    tokens = 2 * 24
    assert out.shape == x.shape and out.device.type == "meta"
    assert c.flops == 2 * tokens * d * e + 2 * tokens * 3 * d * f
    out, _ = moe.moe_ffn_topk_sparse(p, x, cfg)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_collective_bytes_follow_the_specs():
    cfg = C.get_config("qwen3-1.7b")
    for name in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=name == "multi")
        _, _, _, specs = D.cell_state(cfg, "train", 4096, 256, mesh)
        coll = AN.collective_bytes("train", cfg, specs, mesh)
        dp = 32 if name == "multi" else 16
        act = 256 // dp * 4096 * cfg.d_model * 2
        assert coll["all-reduce"] == 4 * cfg.num_layers * act
        assert coll["reduce-scatter"] == SH.bytes_per_device(*specs["master"], mesh)
        assert coll["all-gather"] == SH.bytes_per_device(*specs["params"], mesh)
        assert coll["all-to-all"] == 0 and coll["net_total"] == coll["total"] > 0
    # one NVLink domain: TP 4 x DP 2; one GPU: nothing to move
    mesh = make_local_mesh(data=2, model=4)
    _, _, _, specs = D.cell_state(cfg, "prefill", 1024, 2, mesh)
    coll = AN.collective_bytes("prefill", cfg, specs, mesh)
    assert coll["nvlink_total"] == coll["total"] == 2 * cfg.num_layers * 1024 * cfg.d_model * 2
    _, _, _, specs = D.cell_state(cfg, "decode", 1024, 2, make_local_mesh())
    assert AN.collective_bytes("decode", cfg, specs, make_local_mesh())["total"] == 0
    moe = C.get_config("granite-moe-1b-a400m")
    mesh = make_production_mesh()
    _, _, _, specs = D.cell_state(moe, "decode", 32768, 128, mesh)
    coll = AN.collective_bytes("decode", moe, specs, mesh)
    assert coll["all-to-all"] == moe.top_k * coll["all-reduce"] > 0
    roof = AN.price({"flops": 989e12, "bytes accessed": 3.35e12}, coll)
    assert roof.compute_s == pytest.approx(1.0) and roof.memory_s == pytest.approx(1.0)
    assert roof.collective_s == pytest.approx(coll["total"] / AN.NET_BW)
    assert {f.name for f in dataclasses.fields(AN.Roofline)} == \
        {f.name for f in dataclasses.fields(RRoofline)}


# ---------------------------------------------------------------------------
# The kernel wrappers on meta, on a device they do not take, on the CPU
# ---------------------------------------------------------------------------
class _OtherDevice(torch.Tensor):
    """A tensor that claims a device the kernels do not take; any op on it
    raises."""

    @staticmethod
    def __new__(cls, shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} ran on a device the kernels do not take")


@pytest.mark.parametrize("offset", [0, 40])
def test_k4_on_meta_reports_its_causal_count(offset):
    s, h, kv, hd = 100, 8, 2, 64
    q = torch.empty((2, s, h, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, s + offset, kv, hd), dtype=torch.bfloat16, device="meta")
    before = flash_prefill_op.launches
    out, c = OC.count(lambda: flash_prefill_op(q, k, k, q_offset=offset))
    pairs = s * offset + s * (s + 1) // 2
    assert out.shape == q.shape and out.device.type == "meta"
    assert c.kernels["flash_prefill"]["flops"] == 4 * 2 * h * hd * pairs == c.flops
    assert k4_flops(2, s, s + offset, h, hd, True, offset) == c.flops
    assert c.kernels["flash_prefill"]["launches"] == 1 and flash_prefill_op.launches == before
    _, c = OC.count(lambda: flash_prefill_op(q[:, :20], k[:, :20], k[:, :20], causal=False))
    assert c.flops == 4 * 2 * h * hd * 20 * 20
    with pytest.raises(ValueError, match="kernel supports hd"):
        flash_prefill_op(q[..., :48], k[:, :s, :, :48], k[:, :s, :, :48])


def test_kernels_still_refuse_other_devices_and_run_plain_on_the_cpu():
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill_op(_OtherDevice((1, 8, 4, 16)), _OtherDevice((1, 8, 2, 16)),
                         _OtherDevice((1, 8, 2, 16)))
    with pytest.raises(ValueError, match="unsupported device"):
        paged_decode_attention(_OtherDevice((2, 4, 16)), _OtherDevice((8, 2, 2, 4 * 2 * 16)), 1,
                               _OtherDevice((2, 3), torch.int32), _OtherDevice((2,), torch.int32),
                               block_size=4)
    rng = np.random.RandomState(0)
    q, k = (torch.from_numpy(rng.randn(1, 8, n, 16).astype(np.float32)) for n in (4, 2))
    assert torch.equal(flash_prefill_op(q, k, k), flash_prefill_ref(q, k, k))
    pool = torch.from_numpy(rng.randn(8, 2, 2, 4 * 2 * 16).astype(np.float32))
    qd = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    lens = torch.tensor([9, 5], dtype=torch.int32)
    out, c = OC.count(lambda: paged_decode_attention(qd, pool, 1, bt, lens, block_size=4))
    assert out.shape == qd.shape and "paged_decode_attention" not in c.kernels
    meta = [t.to("meta") for t in (qd, pool, bt, lens)]
    out, c = OC.count(lambda: paged_decode_attention(*meta[:2], 1, *meta[2:], block_size=4))
    assert out.device.type == "meta" and c.flops == 4 * 2 * 4 * 16 * 3 * 4


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def test_dryrun_cli_runs_without_jax_and_writes_the_reference_record():
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--arch', 'qwen3-1.7b', '--shape', 'decode_32k',"
            " '--mesh', 'single']\n"
            "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(D.cell_path("qwen3-1.7b", "decode_32k", "single").read_text())
    ref_keys = {"arch", "shape", "mesh", "status", "kind", "seq", "batch", "chips", "lower_s",
                "compile_s", "resident_bytes_per_device", "cost_analysis_xla", "hlo_parsed",
                "memory_analysis", "collective_bytes", "roofline", "tag", "opts"}
    assert ref_keys <= set(rec) and rec["status"] == "ok" and rec["chips"] == 256
    assert rec["cost_analysis_xla"] is None and rec["hlo_parsed"]["unknown_trip_counts"] == 0
    assert {"flops", "bytes"} <= set(rec["hlo_parsed"])
    assert {f.name for f in dataclasses.fields(RRoofline)} == set(rec["roofline"])
    assert {"argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
            "temp_size_in_bytes"} <= set(rec["memory_analysis"])
    assert math.isclose(rec["hlo_parsed"]["flops"] * 256, rec["hlo_parsed"]["flops_global"])


def test_run_group_traces_each_arch_shape_once_for_both_meshes(monkeypatch):
    """``--mesh both`` (and so ``--all`` and chip_smoke's pool) runs both
    meshes of an (arch, shape) on one trace; the groups cover every
    (arch, shape) once, smallest arch first."""
    traces = []
    real = D.trace
    monkeypatch.setattr(D, "trace", lambda run, inputs: traces.append(1) or real(run, inputs))
    recs = D.run_group("qwen3-1.7b", "decode_32k")
    assert [r["mesh"] for r in recs] == ["single", "multi"] and len(traces) == 1
    assert all(r["status"] == "ok" for r in recs) and recs[1]["chips"] == 2 * recs[0]["chips"]
    assert recs[0]["hlo_parsed"]["flops_global"] == recs[1]["hlo_parsed"]["flops_global"]
    groups = D.all_groups()
    assert sorted(groups) == sorted(D.all_groups(longest_first=True))
    assert len(set(groups)) == len(groups) == len(C.ASSIGNED_ARCHS) * (len(C.SHAPES) + 1)
    assert groups[0][0] == min(C.ASSIGNED_ARCHS, key=lambda a: C.get_config(a).num_params())
