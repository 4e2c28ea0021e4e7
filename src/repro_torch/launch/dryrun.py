"""Multi-pod dry-run: trace every (arch x input-shape) cell at its full size
on the production meshes and record its FLOPs, bytes, memory, collectives
and roofline, priced for the H100. Port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # every cell, both meshes (subprocess per arch x shape)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --aggregate    # print the table from cached JSON

The reference lowers and compiles each cell for a forced 512-device host
mesh and reads the compiled program. The port has neither XLA nor such a
mesh: it runs each cell's step on ``meta`` tensors (shapes and dtypes only,
nothing computed or allocated, on any device) under
``launch/op_counts.OpCounter``, derives collective bytes and memory from
the spec tuples over an ``AbstractMesh`` (``launch/analysis.py``) and
prices the roofline with the H100's data-sheet figures.

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference record's keys: ``lower_s`` and ``compile_s`` are the
trace's wall time, ``cost_analysis_xla`` is null (there is no XLA),
``hlo_parsed`` holds the op counts per chip (``unknown_trip_counts`` is
always 0: eager tracing runs every loop iteration). FLOPs and bytes are
counted once per (arch, shape) at the global batch and divided by the chip
count, so ``--mesh both`` (and ``--all``, which runs it for every (arch,
shape)) traces each once for the two meshes. A failed cell records its
exception: it is a bug, not an outcome.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

MESHES = ("single", "multi")
TRANSFER_SHAPE = "kv_transfer_32k"


def _parse_opts(opt: str) -> dict:
    """'moe_dispatch=gshard,num_heads=64' -> typed dict of config overrides."""
    out = {}
    if not opt:
        return out
    for kv in opt.split(","):
        k, v = kv.split("=")
        if v in ("true", "false"):
            out[k] = v == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def cell_state(cfg, kind: str, seq: int, batch: int, mesh):
    """One cell's step on ``meta`` tensors: (run, inputs, resident, specs).

    ``run()`` runs the step once; ``inputs`` are the tensors it reads;
    ``resident`` is the per-device bytes of what stays on the device (the
    train state under ``state_spec``, params under the TP spec, or params
    plus the decode cache); ``specs`` are the (shapes, spec) pairs that
    ``analysis.collective_bytes`` reads.
    """
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import steps as ST
    from repro_torch.launch import analysis as AN
    from repro_torch.models.api import get_model, input_specs

    model = get_model(cfg)
    specs = {"activations": AN.activation_specs(cfg, kind, seq, batch, mesh)}
    if kind == "train":
        state = ST.abstract_train_state(model)
        train_step, state_spec = ST.make_train_step(model, state["params"], mesh=mesh)
        batch_specs, _ = input_specs(cfg, "train", seq, batch)
        specs["params"] = (state["params"], state_spec["params"])
        specs["master"] = (state["master"], state_spec["master"])
        return (lambda: train_step(state, batch_specs), (state, batch_specs),
                SH.bytes_per_device(state, state_spec, mesh), specs)
    params = model.init(0, "meta")
    p_spec = SH.tree_specs(params, model.param_axes(), mesh)
    resident = SH.bytes_per_device(params, p_spec, mesh)
    if kind == "prefill":
        batch_specs, _ = input_specs(cfg, "prefill", seq, batch)
        step = ST.make_prefill_step(model)
        return lambda: step(params, batch_specs), (params, batch_specs), resident, specs
    dspecs, axes = input_specs(cfg, "decode", seq, batch)
    cache_spec = SH.tree_specs(dspecs["cache"], axes["cache"], mesh)
    resident += SH.bytes_per_device(dspecs["cache"], cache_spec, mesh)
    step = ST.make_decode_step(model)
    return (lambda: step(params, dspecs["token"], dspecs["cache"]),
            (params, dspecs), resident, specs)


def trace(run, inputs) -> dict:
    """Run a cell's step under the op counter: its counts, its output's new
    and aliased bytes, and the trace's wall time."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.launch import op_counts as OC

    def leaves(tree):
        import torch
        return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]

    t0 = time.time()
    out, counts = OC.count(run)
    wall = time.time() - t0
    held = {id(t.untyped_storage()) for t in leaves(inputs)}
    outs = leaves(out)
    alias = sum(OC.tensor_bytes(t) for t in outs if id(t.untyped_storage()) in held)
    return {"counts": counts, "output_bytes": sum(OC.tensor_bytes(t) for t in outs) - alias,
            "alias_bytes": alias, "wall_s": wall}


def _trace_cell(arch: str, shape_name: str, mesh_kind: str, extra_tag: str = "",
                opts: str = "", traced: dict = None):
    """One (arch, shape, mesh) cell. ``traced`` caches the trace by (arch,
    shape, opts): the count does not depend on the mesh, so a caller that
    runs both meshes traces each (arch, shape) once."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch import analysis as AN
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    if opts:
        cfg = dataclasses.replace(cfg, **_parse_opts(opts))
    kind, seq, batch = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "why": why}

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = math.prod(mesh.shape.values())
    run, inputs, resident, specs = cell_state(cfg, kind, seq, batch, mesh)
    key = (arch, shape_name, opts)
    if traced is None or key not in traced:
        res = trace(run, inputs)
        if traced is not None:
            traced[key] = res
    else:
        res = traced[key]
    counts = res["counts"]
    if kind == "train":
        model_flops = 6.0 * cfg.active_params() * batch * seq / n_chips
    elif kind == "prefill":
        model_flops = 2.0 * cfg.active_params() * batch * seq / n_chips
    else:
        model_flops = 2.0 * cfg.active_params() * batch / n_chips
    flops, nbytes = counts.flops / n_chips, counts.bytes / n_chips
    coll = AN.collective_bytes(kind, cfg, specs, mesh)
    roof = AN.price({"flops": flops, "bytes accessed": nbytes}, coll, model_flops=model_flops)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "ok",
        "kind": kind, "seq": seq, "batch": batch, "chips": n_chips,
        "lower_s": round(res["wall_s"], 2), "compile_s": round(res["wall_s"], 2),
        "resident_bytes_per_device": resident,
        "cost_analysis_xla": None,
        "hlo_parsed": {"flops": flops, "bytes": nbytes,
                       "unknown_trip_counts": counts.unknown_trip_counts,
                       "flops_global": counts.flops, "bytes_global": counts.bytes,
                       "ops": counts.ops, "flops_by_op": dict(counts.flops_by_op),
                       "bytes_by_op": dict(counts.bytes_by_op), "kernels": counts.kernels},
        "memory_analysis": AN.memory_analysis_dict(resident, res["output_bytes"],
                                                   res["alias_bytes"], counts.peak_bytes,
                                                   n_chips),
        "collective_bytes": coll,
        "roofline": roof.as_dict(),
        "tag": extra_tag,
    }


def predict(arch: str, shape_name: str, batch: int, opts: str = "") -> dict:
    """One cell cut to ``batch`` sequences on one GPU (a 1 x 1 mesh): what the
    dry-run predicts for the step run there: the resident bytes, the step's
    counted FLOPs, bytes and live-set peak, and its roofline (one GPU has no
    collectives)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import analysis as AN
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_config(arch)
    if opts:
        cfg = dataclasses.replace(cfg, **_parse_opts(opts))
    kind, seq, _ = SHAPES[shape_name]
    run, inputs, resident, _ = cell_state(cfg, kind, seq, batch, make_local_mesh())
    res = trace(run, inputs)
    c = res["counts"]
    roof = AN.price({"flops": c.flops, "bytes accessed": c.bytes},
                    {"total": 0, "nvlink_total": 0, "net_total": 0})
    return {"arch": arch, "shape": shape_name, "kind": kind, "seq": seq, "batch": batch,
            "opts": opts, "resident_bytes": resident, "flops": c.flops, "bytes": c.bytes,
            "temp_bytes": c.peak_bytes, "kernels": c.kernels, "trace_s": res["wall_s"],
            "roofline": roof.as_dict()}


def _transfer_cell(arch: str):
    """Price the FlowKV P->D transfer through the descriptor-table plane.

    The pool comes from ``kv_transfer_specs`` (32k tokens x 128 sequences),
    and the cell reports the exact plan the executor would dispatch,
    including the per-shard-pair fused dispatch counts for mesh-parallel
    pools, as the reference's cell does. The plan's one K1 launch is run on
    ``meta`` pools, which counts its bytes and moves nothing.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import sharded_transfer_calls
    from repro_torch.core.layout import KVCacheSpec
    from repro_torch.core.transfer import TransferPlanner
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels.kv_gather import kv_transfer
    from repro_torch.launch import op_counts as OC
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=True)
    t0 = time.time()
    spec, _ = ST.kv_transfer_specs(cfg, mesh, seq=32768, batch=128)
    pool_bytes = cfg.dtype.itemsize * math.prod(spec.shape)
    rec = {
        "arch": arch, "shape": TRANSFER_SHAPE, "mesh": "multi", "status": "ok",
        "kind": "transfer", "pool_bytes_global": pool_bytes,
    }
    n_attn = cfg.num_attention_layers()
    if n_attn > 0:
        kv_spec = KVCacheSpec(
            num_layers=n_attn,
            num_blocks=128 * -(-32768 // cfg.block_size),
            block_size=cfg.block_size,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            dtype=cfg.dtype,
        )
        blocks = list(range(kv_spec.num_blocks))
        plan = TransferPlanner(kv_spec).plan_flowkv(blocks, blocks)
        lo, hi = plan.layer_span
        pages = torch.empty(plan.num_blocks * (hi - lo) * 2, dtype=torch.int32, device="meta")
        _, counts = OC.count(kv_transfer, spec, torch.empty_like(spec), pages, pages)
        rec["plan"] = {
            "schedule": "flowkv",
            "num_calls": plan.num_calls,
            "total_bytes": plan.total_bytes,
            "num_blocks": plan.num_blocks,
            "shard_pair_dispatches": {
                f"tp{s}->tp{d}": sharded_transfer_calls(s, d)
                for s, d in ((1, 1), (2, 1), (4, 1), (4, 2))
                if cfg.num_kv_heads % max(s, d) == 0
            },
        }
        rec["op_counts"] = counts.as_dict()
    rec["compile_s"] = round(time.time() - t0, 2)
    return rec


def cell_path(arch: str, shape: str, mesh: str, tag: str = "") -> pathlib.Path:
    if tag:
        d = RESULTS_DIR.parent / "perf_torch"
        d.mkdir(parents=True, exist_ok=True)
        return d / f"{arch}__{shape}__{mesh}__{tag}.json"
    return RESULTS_DIR / f"{arch}__{shape}__{mesh}.json"


def run_cell(arch: str, shape: str, mesh: str, tag: str = "", opts: str = "",
             traced: dict = None) -> dict:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    try:
        if shape == TRANSFER_SHAPE:
            rec = _transfer_cell(arch)
        else:
            rec = _trace_cell(arch, shape, mesh, extra_tag=tag, opts=opts, traced=traced)
            rec["opts"] = opts
    except Exception as e:  # noqa: BLE001 — recorded, cell marked failed
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
               "opts": opts, "status": "failed",
               "error": f"{type(e).__name__}: {e}"}
    cell_path(arch, shape, mesh, tag).write_text(json.dumps(rec, indent=1))
    return rec


def group_meshes(shape: str) -> tuple:
    """The meshes of one (arch, shape): both, or the transfer cell's one."""
    return ("multi",) if shape == TRANSFER_SHAPE else MESHES


def run_group(arch: str, shape: str, tag: str = "", opts: str = "") -> list:
    """The cells of one (arch, shape), in this process, on one trace."""
    traced: dict = {}
    return [run_cell(arch, shape, m, tag=tag, opts=opts, traced=traced)
            for m in group_meshes(shape)]


def all_groups(archs=None, longest_first: bool = False) -> list:
    """Every (arch, shape), then the transfer cells, smallest arch first (by
    parameter count), as the reference orders its cells. ``longest_first``:
    train cells, largest arch first, the order to hand them to a pool of
    processes."""
    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config

    size = {a: get_config(a).num_params() for a in archs or ASSIGNED_ARCHS}
    order = sorted(size, key=size.get)
    groups = [(a, s) for a in order for s in SHAPES] + [(a, TRANSFER_SHAPE) for a in order]
    if longest_first:
        groups.sort(key=lambda g: (not g[1].startswith("train"), -size[g[0]]))
    return groups


def run_all(archs=None, force: bool = False):
    """Drive every (arch, shape) in a fresh subprocess running
    :func:`run_group` (its trace and memory stay in its own process)."""
    root = pathlib.Path(__file__).resolve().parents[3]
    for arch, shape in all_groups(archs):
        paths = [cell_path(arch, shape, m) for m in group_meshes(shape)]
        if not force and all(p.exists() for p in paths):
            recs = [json.loads(p.read_text()) for p in paths]
            if all(r.get("status") in ("ok", "skipped") for r in recs):
                print(f"[cached] {arch} {shape}: {recs[0]['status']}")
                continue
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", "both"],
            capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(root / "src")}, cwd=str(root),
        )
        for mesh, path in zip(group_meshes(shape), paths):
            status = json.loads(path.read_text()).get("status") if path.exists() else "?"
            print(f"[{time.time()-t0:7.1f}s] {arch} {shape} {mesh}: {status}"
                  + ("" if proc.returncode == 0 else f" (rc={proc.returncode})"))
            if proc.returncode != 0 and not path.exists():
                path.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh, "status": "failed",
                    "error": proc.stderr[-2000:]}, indent=1))


def aggregate() -> list:
    recs = []
    for p in sorted(RESULTS_DIR.glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=MESHES + ("both",), default="single",
                    help="both: the two meshes on one trace")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--aggregate", action="store_true")
    ap.add_argument("--tag", default="", help="perf-run tag (writes results/perf_torch/)")
    ap.add_argument("--opt", default="",
                    help="config overrides, e.g. moe_dispatch=gshard,attn_wedge=true")
    args = ap.parse_args()

    if args.aggregate:
        for r in aggregate():
            line = f"{r['arch']:26s} {r['shape']:16s} {r['mesh']:6s} {r['status']}"
            if r["status"] == "ok" and "roofline" in r:
                rf = r["roofline"]
                line += (f"  comp={rf['compute_s']:.4f}s mem={rf['memory_s']:.4f}s "
                         f"coll={rf['collective_s']:.4f}s -> {rf['bottleneck']}")
            print(line)
        return
    if args.all:
        run_all(archs=[args.arch] if args.arch else None, force=args.force)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required")
    if args.mesh == "both":
        recs = run_group(args.arch, args.shape, tag=args.tag, opts=args.opt)
        for r in recs:
            print(f"{r['arch']} {r['shape']} {r['mesh']}: {r['status']}")
    else:
        recs = [run_cell(args.arch, args.shape, args.mesh, tag=args.tag, opts=args.opt)]
        print(json.dumps(recs[0], indent=1)[:4000])
    if any(r["status"] == "failed" for r in recs):
        sys.exit(1)


if __name__ == "__main__":
    main()
