"""The PyTorch port stands alone: it imports without JAX or the reference
package, and its entry points refuse a missing GPU instead of quietly
running on the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_every_module_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
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

    cfg = get_smoke_config("qwen3-1.7b")
    params = T.init_params(cfg, 0, device="cpu")
    return {
        "init_params": lambda dev: T.init_params(cfg, 0, device=dev),
        "model.init": lambda dev: get_model(cfg).init(0, dev),
        "from_reference": lambda dev: bridge.from_reference(
            {"embed": params["embed"].numpy()}, cfg, device=dev),
        "NodeEngine": lambda dev: NodeEngine(0, cfg, params, num_blocks=8, device=dev),
        "PDCluster": lambda dev: PDCluster(cfg, params, num_blocks=8, device=dev),
        "FlowKVClient": lambda dev: FlowKVClient(cfg, params, num_blocks=8, device=dev),
    }


@pytest.mark.parametrize("name", ["init_params", "model.init", "from_reference",
                                  "NodeEngine", "PDCluster", "FlowKVClient"])
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
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.transfer import ShardedTransferEngine
    from repro_torch.models import transformer as T
    from repro_torch.serving.cluster import PDCluster
    from repro_torch.serving.kv_cache import ShardedKVCache

    cfg = get_smoke_config("qwen3-1.7b")
    params = T.init_params(cfg, 0, device="cpu")
    cases = [
        (lambda: get_smoke_config("granite-moe-1b-a400m"), "item 9"),
        (lambda: get_smoke_config("mamba2-370m"), "item 11"),
        (lambda: PDCluster(cfg, params, num_blocks=8, device="cpu",
                           tp_degrees={0: 2}), "item 9"),
        (lambda: PDCluster(cfg, params, num_blocks=8, device="cpu",
                           host_tier_blocks=4), "item 8"),
        (lambda: PDCluster(cfg, params, num_blocks=8, device="cpu").checkpoint(),
         "item 7"),
        (lambda: ShardedKVCache(None, 2), "item 9"),
        (lambda: ShardedTransferEngine(None, None, None, None), "item 9"),
    ]
    for fn, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            fn()
