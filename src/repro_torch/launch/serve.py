"""End-to-end serving driver of the PyTorch port (reference:
``repro/launch/serve.py``).

``--engine real`` runs real PyTorch compute through the PD cluster via the
:class:`repro_torch.serving.api.FlowKVClient` streaming facade, on the GPU
by default (``--device cuda``; ``--device cpu`` for a smoke run). The
weights are random, made from ``--seed``; ``--full`` takes the arch's
full-size config instead of its smoke config. ``--engine sim`` waits for
ROADMAP.md item 10.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --engine real
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--engine", choices=("real", "sim"), default="real")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-size config instead of the smoke config")
    ap.add_argument("--schedule", default="flowkv",
                    choices=("flowkv", "layerwise", "blockwise"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--num-prefill", type=int, default=1)
    ap.add_argument("--num-decode", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--role-flip", action="store_true",
                    help="let the load-aware scheduler reassign P<->D roles "
                         "under imbalance")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.engine == "sim":
        raise NotImplementedError(
            "--engine sim is not ported yet: see ROADMAP.md item 10")
    print(json.dumps(run_real(args), indent=1, default=str))


if __name__ == "__main__":
    main()
