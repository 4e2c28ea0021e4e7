"""What the paged decode step's CUDA graphs cost and save, on the card.

    python3 tools/graph_probe.py [--workload qwen3-1.7b.lb-qa --seed N] [--out DIR]
    python3 tools/graph_probe.py --serve-arch granite-moe-1b-a400m [--seed N] [--out DIR]

Two parts, one JSON line each (also written to ``<out>/graph_probe.json``,
``build/graph_probe/`` of the checkout unless ``--out`` names another folder):

* ``graph_steps``: full-width qwen3-1.7b (bf16, random weights and pool) at
  the buckets (1, 2), (8, 512), (16, 512) and (32, 512): the eager step's
  host enqueue and wall, the capture's own cost (the synchronise, the
  forward under capture and the instantiation), and a replay's host time
  (the inputs' copies, the guard and the replay call) and wall, each the
  median of 20 steps, with and without ``torch.profiler`` tracing the card
  (CUDA activity, as the benchmark's traced runs do);
* ``graph_run`` (with ``--workload``): one untraced run of the benchmark
  cell with every engine's captures timed: how many, their seconds in
  set-up and in the window, and the buckets.

``--serve-arch`` runs a third part alone, ``serve_walls``: that
architecture at full width in its own dtype (random weights) served 1P+1D
at TP 1 through ``FlowKVClient``, 8 prompts of 200-1500 tokens and 64 new
tokens each, twice on one client; the second pass is timed: its wall and
each decode step's synchronised wall, with the engines' captures and
replays where they have graphs. It runs on a checkout without graphs as
well, so the same command compares two checkouts.

Each step's wall ends in a synchronise; host times do not.
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

BUCKETS = ((1, 2), (8, 512), (16, 512), (32, 512))


def _inputs(rng, lanes, width, nb, bs, vocab):
    """A full bucket: every lane real, its pages distinct blocks."""
    lens = rng.integers(width * bs // 2, width * bs - 1, size=lanes)
    perm = rng.permutation(nb)
    tables = np.zeros((lanes, width), np.int32)
    off = 0
    for i, n in enumerate(lens // bs + 1):
        tables[i, :n] = perm[off:off + n] if off + n <= nb else perm[:n]
        off += n
    return (rng.integers(0, vocab, size=lanes).astype(np.int32), tables,
            lens.astype(np.int32))


def _median_ms(xs):
    return 1000.0 * statistics.median(xs)


def graph_steps(n=20) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import api as API
    from repro_torch.serving.decode_graphs import DecodeGraphs

    cfg = get_config("qwen3-1.7b")
    model = API.get_model(cfg)
    params = model.init(0, "cuda")
    payload = cfg.block_size * cfg.num_kv_heads * cfg.head_dim
    nb = 2048
    pool = torch.randn((nb, cfg.num_layers, 2, payload), device="cuda").to(cfg.dtype)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    graphs = DecodeGraphs(torch.device("cuda", 0), cfg.num_kv_heads)
    rng = np.random.default_rng(0)
    out = {}
    for lanes, width in BUCKETS:
        arrs = _inputs(rng, lanes, width, nb, cfg.block_size, cfg.vocab_size)
        dev = [torch.from_numpy(a).cuda() for a in arrs]
        row = {}
        enq, wall = [], []
        for _ in range(n + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.decode_paged(params, dev[0], pool, dev[1], dev[2])
            t1 = time.perf_counter()
            logits.argmax(-1).cpu()
            enq.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
        row["eager_host_ms"], row["eager_wall_ms"] = _median_ms(enq[2:]), _median_ms(wall[2:])
        b = graphs.stage(*arrs)
        t0 = time.perf_counter()
        _, how = graphs.run(b, model.decode_paged, params, pool)
        row["first_sight_ms"] = 1000.0 * (time.perf_counter() - t0)
        assert how == "capture"
        # the capture alone, in a second set of graphs, after the first's
        # eager step and capture warmed the bucket up
        other = DecodeGraphs(torch.device("cuda", 0), cfg.num_kv_heads)
        b2 = other.stage(*arrs)
        t0 = time.perf_counter()
        other._capture(b2, model.decode_paged, params, pool)
        row["capture_ms"] = 1000.0 * (time.perf_counter() - t0)
        del other, b2
        for traced in (False, True):
            host, wall = [], []
            prof = profile(activities=[ProfilerActivity.CUDA]) if traced else None
            if prof is not None:
                prof.start()
            for _ in range(n + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, how = graphs.run(graphs.stage(*arrs), model.decode_paged, params, pool)
                t1 = time.perf_counter()
                logits.argmax(-1).cpu()
                host.append(t1 - t0)
                wall.append(time.perf_counter() - t0)
                assert how == "replay", how
            if prof is not None:
                torch.cuda.synchronize()
                prof.stop()
            tag = "traced" if traced else "untraced"
            row[f"replay_host_ms_{tag}"] = _median_ms(host[2:])
            row[f"replay_wall_ms_{tag}"] = _median_ms(wall[2:])
        out[f"{lanes}x{width}"] = row
    # what the four buckets' graphs and buffers hold beyond the weights and
    # the pool, live and reserved
    out["graphs_allocated_bytes"] = torch.cuda.memory_allocated() - mem0[0]
    out["graphs_reserved_bytes"] = torch.cuda.memory_reserved() - mem0[1]
    del graphs, pool, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def graph_run(workload: str, seed: int) -> dict:
    from flowbench import harness

    captures = []

    def plant(client):
        for nid, eng in client.cluster.engines.items():
            g = eng.graphs
            if g is None:
                continue

            def timed(b, *a, _cap=g._capture, _nid=nid):
                t0 = time.monotonic()
                _cap(b, *a)
                captures.append((_nid, t0, time.monotonic() - t0, tuple(b.dev[1].shape)))
            g._capture = timed

    t_process = time.monotonic()
    res = harness.execute(workload, seed, 51.0, False, bench_root=ROOT, t_process=t_process,
                          plant=plant)
    t_window = t_process + res["summary"]["setup_s"]
    before = [c for c in captures if c[1] < t_window]
    after = [c for c in captures if c[1] >= t_window]
    return {"correct": res["correct"], "metrics": {k: v["value"] for k, v in
                                                   res["metrics"].items()},
            "setup_s": res["summary"]["setup_s"],
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
            "captures_setup": len(before), "capture_s_setup": sum(c[2] for c in before),
            "captures_window": len(after), "capture_s_window": sum(c[2] for c in after),
            "buckets": sorted({f"{c[3][0]}x{c[3][1]}" for c in captures},
                              key=lambda k: [int(x) for x in k.split("x")]),
            "capture_ms_p50": _median_ms([c[2] for c in captures]) if captures else None}


def serve_walls(arch: str, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import api as API
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    cfg = get_config(arch)
    params = API.get_model(cfg).init(seed, "cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (200, 400, 640, 800, 1100, 1200, 1400, 1500)]
    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1, num_blocks=1024,
                          max_batch_tokens=4096, device="cuda")
    walls = []
    for eng in client.cluster.engines.values():
        def timed(decision, _run=eng.run_decode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _run(decision)
            torch.cuda.synchronize()
            if decision.decode_batch:
                walls.append(time.perf_counter() - t0)
            return out
        eng.run_decode = timed
    for _ in range(2):          # the first pass builds the kernels and captures
        walls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [client.submit(p, SamplingParams(max_new_tokens=64)) for p in prompts]
        client.drain(max_cycles=2000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engines = client.cluster.engines.values()
    return {"arch": arch, "dtype": str(cfg.dtype), "serve_s": wall,
            "finished": sum(len(h.request.output_tokens) == 64 for h in handles),
            "decode_steps": len(walls), "decode_wall_ms_p50": _median_ms(walls),
            "decode_wall_ms_sum": 1000.0 * sum(walls),
            "captures": sum(getattr(e, "decode_graph_captures", 0) for e in engines),
            "replays": sum(getattr(e, "decode_graph_replays", 0) for e in engines)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--serve-arch")
    ap.add_argument("--out", type=pathlib.Path, default=ROOT / "build" / "graph_probe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("graph_probe: no CUDA device", file=sys.stderr)
        return 1
    res = {"device": torch.cuda.get_device_name(0)}
    if args.serve_arch:
        res["serve_walls"] = serve_walls(args.serve_arch, args.seed)
        print("serve_walls " + json.dumps(res["serve_walls"]), flush=True)
    else:
        res["graph_steps"] = graph_steps()
        print("graph_steps " + json.dumps(res["graph_steps"]), flush=True)
    if args.workload:
        res["graph_run"] = graph_run(args.workload, args.seed)
        print("graph_run " + json.dumps(res["graph_run"]), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "graph_probe.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
