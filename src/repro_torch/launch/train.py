"""Training driver of the PyTorch port (reference: ``repro/launch/train.py``):
any registered arch (smoke-sized unless ``--full-config``), AdamW with fp32
master weights, crash-safe checkpointing + resume-from-latest.

It runs on the GPU by default (``--device cuda``) and refuses a machine
without one; ``--device cpu`` runs it on the CPU. The weights are random,
made from ``--seed``; the batches come from ``np.random.RandomState(seed)``
exactly as the reference's launcher draws them, so both see the same
tokens (and frames, for enc-dec).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 50 \\
        --ckpt-dir ckpt --ckpt-every 20
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full config instead of smoke")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def batch_stream(cfg, rng: np.random.RandomState, batch: int, seq: int,
                 device) -> Callable[[], Dict[str, torch.Tensor]]:
    """The reference launcher's ``batch_at``: each call draws the next
    batch from ``rng`` (labels = tokens; frames for enc-dec)."""
    def next_batch() -> Dict[str, torch.Tensor]:
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))).to(device)
        b = {"tokens": toks, "labels": toks}
        if cfg.family == "encdec":
            frames = rng.randn(batch, seq, cfg.d_model).astype(np.float32)
            b["frames"] = torch.from_numpy(frames).to(device)
        return b

    return next_batch


def train_loop(state, step_fn, next_batch, start_step: int, steps: int,
               ckpt_dir: str = "", ckpt_every: int = 50, log=print):
    """``steps`` train steps from ``start_step``, logging as the reference
    does and checkpointing every ``ckpt_every`` steps and at the end.
    Returns (state, the losses as floats)."""
    from repro_torch.serving.checkpoint import save_train_state

    losses: List[float] = []
    t0 = time.time()
    last = start_step + steps - 1
    for i in range(start_step, start_step + steps):
        state, metrics = step_fn(state, next_batch())
        losses.append(float(metrics["loss"]))
        if i % 5 == 0 or i == last:
            log(f"step {i:5d}  loss={losses[-1]:.4f}  "
                f"gnorm={float(metrics['grad_norm']):.3f}  {(time.time() - t0):.1f}s")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            log(f"checkpointed -> {save_train_state(state, i + 1, ckpt_dir)}")
    if ckpt_dir:
        save_train_state(state, start_step + steps, ckpt_dir)
    return state, losses


def run(args, params=None, log=print):
    """The launcher's run on parsed ``args``; ``params`` replaces the seeded
    init (tests bridge the reference's). Returns (state, losses)."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import steps as ST
    from repro_torch.models.api import get_model
    from repro_torch.serving.checkpoint import latest_checkpoint, load_train_state
    from repro_torch.training import optimizer as OPT

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    model = get_model(cfg)
    if params is None:
        params = model.init(args.seed, device)
    state = OPT.init_state(params)
    start_step = 0
    if args.resume and args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            state = load_train_state(state, path)
            start_step = int(state["step"])
            log(f"resumed from {path} at step {start_step}")
    train_step, _ = ST.make_train_step(
        model, opt_cfg=OPT.AdamWConfig(lr=args.lr, warmup_steps=10))
    next_batch = batch_stream(cfg, np.random.RandomState(args.seed), args.batch,
                              args.seq, device)
    return train_loop(state, train_step, next_batch, start_step, args.steps,
                      args.ckpt_dir, args.ckpt_every, log)


def main(argv: Optional[List[str]] = None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
