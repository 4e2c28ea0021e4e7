"""End-to-end serving driver of the PyTorch port (reference:
``repro/launch/serve.py``).

``--engine real`` runs real PyTorch compute through the PD cluster via the
:class:`repro_torch.serving.api.FlowKVClient` streaming facade, on the GPU
by default (``--device cuda``; ``--device cpu`` for a smoke run). The
weights are random, made from ``--seed``; ``--full`` takes the arch's
full-size config instead of its smoke config.

``--engine sim`` runs the discrete-event cluster simulator
(:mod:`repro_torch.sim.cluster_sim`): the same control plane with the
hardware profiles' costs (A100/L20/H20/H100/TPUv5e). It touches no tensor,
so it has no device to choose; its stats equal the reference's for the same
arguments.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --engine real
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b --engine sim \\
        --system flowkv --workload 1k --rps 1.0
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def run_real(args) -> dict:
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    params = get_model(cfg).init(args.seed, device)
    client = FlowKVClient(cfg, params, num_prefill=args.num_prefill,
                          num_decode=args.num_decode, num_blocks=args.blocks,
                          transfer_schedule=args.schedule,
                          role_flip=args.role_flip, device=device)
    rng = np.random.RandomState(args.seed)
    handles = [client.submit(rng.randint(0, cfg.vocab_size,
                                         size=rng.randint(8, 48)).tolist(),
                             SamplingParams(max_new_tokens=args.max_new_tokens))
               for _ in range(args.requests)]
    client.drain(max_cycles=500)
    stats = client.stats()
    stats["device"] = str(device)
    stats["outputs"] = {h.request_id: h.request.output_tokens for h in handles[:4]}
    stats["timing"] = {h.request_id: h.stats() for h in handles[:4]}
    return stats


def run_sim(args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.sim.cluster_sim import ClusterSim
    from repro_torch.sim.hardware import get_hardware
    from repro_torch.sim.workload import LONGBENCH, SIMULATED, generate

    cfg = get_config(args.arch)
    wl = {**SIMULATED, **LONGBENCH}[args.workload]
    sim = ClusterSim(cfg, args.system, num_prefill=args.num_prefill,
                     num_decode=args.num_decode,
                     hw_prefill=get_hardware(args.hw_prefill),
                     hw_decode=get_hardware(args.hw_decode),
                     same_host=args.same_host, tp=args.tp)
    return sim.run(generate(wl, rps=args.rps, seed=args.seed), t_max=100_000)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--engine", choices=("real", "sim"), default="real")
    ap.add_argument("--device", default="cuda", help="real engine only")
    ap.add_argument("--system", default="flowkv")
    ap.add_argument("--full", action="store_true",
                    help="full-size config instead of the smoke config")
    ap.add_argument("--schedule", default="flowkv",
                    choices=("flowkv", "layerwise", "blockwise"))
    ap.add_argument("--workload", default="1k")
    ap.add_argument("--rps", type=float, default=1.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--num-prefill", type=int, default=1)
    ap.add_argument("--num-decode", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--role-flip", action="store_true",
                    help="let the load-aware scheduler reassign P<->D roles "
                         "under imbalance (real engine)")
    ap.add_argument("--hw-prefill", default="a100")
    ap.add_argument("--hw-decode", default="a100")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--same-host", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    stats = run_real(args) if args.engine == "real" else run_sim(args)
    print(json.dumps(stats, indent=1, default=str))


if __name__ == "__main__":
    main()
