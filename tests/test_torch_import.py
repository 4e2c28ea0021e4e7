"""The PyTorch port stands alone: it imports without JAX or the reference
package, and its entry points refuse a missing GPU instead of quietly
running on the CPU."""
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_every_module_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "need = {'repro_torch.models.moe', 'repro_torch.distributed.sharding',\n"
        "        'repro_torch.distributed.tp', 'repro_torch.models.mamba2',\n"
        "        'repro_torch.models.griffin', 'repro_torch.models.encdec',\n"
        "        'repro_torch.training.optimizer', 'repro_torch.distributed.steps',\n"
        "        'repro_torch.launch.train', 'repro_torch.launch.dryrun',\n"
        "        'repro_torch.launch.mesh', 'repro_torch.launch.op_counts',\n"
        "        'repro_torch.launch.analysis'}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40


def test_no_file_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|"
                     r"import repro\s*$|from repro import)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
                 if pat.search(p.read_text())]
    assert not offenders, offenders
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not pat.search(smoke)


def _entry_points():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import bridge
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_model
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.cluster import PDCluster
    from repro_torch.serving.engine import NodeEngine

    from repro_torch.distributed.steps import abstract_train_state
    from repro_torch.launch import train as LT
    from repro_torch.serving.checkpoint import load_train_state, save_train_state
    from repro_torch.training.optimizer import init_state

    cfg = get_smoke_config("qwen3-1.7b")
    params = T.init_params(cfg, 0, device="cpu")
    ckpt = save_train_state(init_state(params), 0, tempfile.mkdtemp())
    train_argv = ["--steps", "1", "--batch", "1", "--seq", "8"]
    return {
        "init_params": lambda dev: T.init_params(cfg, 0, device=dev),
        "model.init": lambda dev: get_model(cfg).init(0, dev),
        "from_reference": lambda dev: bridge.from_reference(
            {"embed": params["embed"].numpy()}, cfg, device=dev),
        "NodeEngine": lambda dev: NodeEngine(0, cfg, params, num_blocks=8, device=dev),
        "PDCluster": lambda dev: PDCluster(cfg, params, num_blocks=8, device=dev),
        "FlowKVClient": lambda dev: FlowKVClient(cfg, params, num_blocks=8, device=dev),
        "launch.train": lambda dev: LT.run(LT.build_parser().parse_args(
            train_argv + ([] if dev is None else ["--device", dev])), log=lambda line: None),
        "load_train_state": lambda dev: load_train_state(
            abstract_train_state(get_model(cfg)), ckpt, device=dev),
    }


@pytest.mark.parametrize("name", ["init_params", "model.init", "from_reference",
                                  "NodeEngine", "PDCluster", "FlowKVClient",
                                  "launch.train", "load_train_state"])
def test_entry_points_refuse_missing_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run there")
    fn = _entry_points()[name]
    fn("cpu")                                     # the CPU works when asked for
    with pytest.raises(RuntimeError, match="cuda"):
        fn("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        fn(None)                                  # the default is the GPU


def test_launcher_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher runs there")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--requests", "1", "--max-new-tokens", "2"],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "cuda" in out.stderr


def test_out_of_scope_features_name_their_roadmap_item():
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.transfer import ShardedTransferEngine, ShardSpec
    from repro_torch.models import transformer as T
    from repro_torch.serving.cluster import PDCluster
    from repro_torch.serving.kv_cache import ShardedKVCache, spec_for_model

    cfg = get_smoke_config("qwen3-1.7b")
    params = T.init_params(cfg, 0, device="cpu")
    # item 11 is ported: the state families' configs resolve, with the
    # reference's families, and build their models (the no-JAX import
    # check above walks their modules too)
    from repro_torch.models.api import get_model

    for arch, family in (("mamba2-370m", "ssm"), ("recurrentgemma-2b", "hybrid"),
                         ("seamless-m4t-large-v2", "encdec")):
        assert get_config(arch).family == get_smoke_config(arch).family == family
        assert get_model(get_smoke_config(arch)).decode_paged is None
    # item 9 is ported: MoE, VLM and tensor/expert-parallel serving
    for arch, family in (("granite-moe-1b-a400m", "moe"), ("llama4-scout-17b-a16e", "moe"),
                         ("llava-next-34b", "vlm")):
        assert get_config(arch).family == get_smoke_config(arch).family == family
    tp = PDCluster(cfg, params, num_blocks=8, device="cpu", tp_degrees={0: 2})
    assert tp.engines[0].tp_degree == 2 and isinstance(tp.engines[0].kv, ShardedKVCache)
    spec = spec_for_model(cfg, 8)
    assert len(ShardedKVCache(spec, 2, device="cpu").pools) == 2
    ShardedTransferEngine(spec, spec, ShardSpec(2, 2), ShardSpec(1, 2))
    # items 8 and 7 are ported: the host tier and the serving checkpoint work
    from repro_torch.serving.host_tier import TierManager

    tiered = PDCluster(cfg, params, num_blocks=8, device="cpu", host_tier_blocks=4)
    assert sorted(tiered.tiers) == sorted(tiered.engines)
    assert all(isinstance(tm, TierManager) and tm.host.num_blocks == 4
               and tiered.engines[nid].tier is tm for nid, tm in tiered.tiers.items())
    state = PDCluster(cfg, params, num_blocks=8, device="cpu").checkpoint()
    assert set(state) == {"clock", "nodes", "finished", "cancelled", "rejected"}
    # item 12a is ported: the training path (loss, optimizer, train step,
    # train-state checkpoint, launcher) for every family
    from repro_torch.distributed import steps as ST
    from repro_torch.serving.checkpoint import load_train_state, save_train_state
    from repro_torch.training import optimizer as OPT

    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m", "mamba2-370m", "recurrentgemma-2b",
                 "seamless-m4t-large-v2"):
        model = get_model(get_smoke_config(arch))
        tr_state = OPT.init_state(model.init(0, "cpu"))
        step, spec = ST.make_train_step(model)
        assert set(spec) == {"params", "master", "m", "v", "step"}
        toks = torch.zeros((1, 8), dtype=torch.long)
        batch = {"tokens": toks, "labels": toks}
        if model.cfg.family == "encdec":
            batch["frames"] = torch.zeros((1, 8, model.cfg.d_model))
        tr_state, metrics = step(tr_state, batch)
        assert bool(torch.isfinite(metrics["loss"])) and int(tr_state["step"]) == 1
    with tempfile.TemporaryDirectory() as d:
        back = load_train_state(ST.abstract_train_state(model),
                                save_train_state(tr_state, 1, d), device="cpu")
        assert int(back["step"]) == 1
    # item 12b is ported: the dry-run accounting (cells, input specs, the
    # production meshes, op counts on meta, the H100 roofline)
    from repro_torch.configs import ASSIGNED_ARCHS, list_cells
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.api import input_specs

    assert len(list_cells()) == 4 * len(ASSIGNED_ARCHS) == 40
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    specs, _ = input_specs(get_config("qwen3-1.7b"), "prefill", 32768, 32)
    assert specs["tokens"].device.type == "meta"
    assert D.predict("qwen3-1.7b", "decode_32k", 1)["flops"] > 0
