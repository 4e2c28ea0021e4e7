"""Fit the cost-model coefficients from measured timings (port of
``repro/obs/calibrate.py``).

The simulator and the controller price everything with two small linear
models:

* :class:`repro_torch.core.costmodel.TransportProfile` —
  ``latency = fixed_s + calls*per_call_s + bytes/bandwidth_Bps``
* :class:`repro_torch.sim.hardware.HardwareProfile` prefill —
  ``predicted_ttft_s = overhead_s + flops / (peak_flops * mfu_prefill)``

Both are linear in their unknowns, so ordinary least squares over measured
``(calls, bytes, seconds)`` / ``(flops, seconds)`` samples recovers the
coefficients exactly on synthetic data and usefully on real data. The fits
and :data:`TTFT_ERROR_BOUND` are the reference's, line for line.

FLOP counts are the reference's analytic model (``2 * active_params`` per
token plus the quadratic attention term). The reference's sweep refines it
with the compiled prefill's HLO; the port has no HLO, so its sweep passes
:func:`prefill_flops` the op count of the same prefill traced on ``meta``
(``launch/op_counts.py``) instead.

The sweep times the port's own prefill (``models/transformer.py::prefill``)
on the device named: on the GPU (the default) it calibrates that card,
and the fitted profile starts from the ``H100`` profile; with ``--device
cpu`` it calibrates the host at the smoke config's size from the
reference's ``TPU_V5E`` default. Nothing falls back to the CPU when the GPU
is missing.

``--check`` is the sim-vs-real gate: fit a :class:`HardwareProfile` on the
even points of the sweep, predict the odd ones with ``predicted_ttft_s``
and require the median relative error under :data:`TTFT_ERROR_BOUND`.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.calibrate --check               # the GPU
    PYTHONPATH=src python -m repro_torch.obs.calibrate --check --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import TransportProfile, predicted_ttft_s
from repro_torch.sim.hardware import H100, TPU_V5E, HardwareProfile

# Documented sim-vs-real bound for --check: median relative error of
# predicted vs measured prefill TTFT on held-out lengths. Wide on purpose:
# the gate's job is catching structural breaks (sign flip, unit slip,
# constant-only fit) — those miss by integer factors.
TTFT_ERROR_BOUND = 0.75

# The reference's CPU sweep; on the GPU the full-size model sweeps both sides
# of ``flash_threshold`` (1024), so the longer half launches K4.
CPU_PROMPT_LENS = (32, 64, 96, 128, 160, 192, 224, 256)
GPU_PROMPT_LENS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
REPEATS = 5             # timed calls a length; the minimum wall is kept


# -- transport: latency = fixed + calls*per_call + bytes/bw ---------------------
def fit_transport(samples: Sequence[Tuple[int, int, float]],
                  name: str = "fitted") -> TransportProfile:
    """Least-squares fit of (num_calls, num_bytes, seconds) samples.

    Needs >= 3 samples spanning distinct calls AND bytes values (the design
    matrix [1, calls, bytes] must have full column rank) — synthetic
    recovery is exact, measured fits are clamped to physical (>= 0)
    coefficients.
    """
    if len(samples) < 3:
        raise ValueError(f"need >= 3 samples to fit 3 coefficients, "
                         f"got {len(samples)}")
    a = np.array([[1.0, c, b] for c, b, _ in samples])
    y = np.array([t for _, _, t in samples])
    (fixed, per_call, per_byte), *_ = np.linalg.lstsq(a, y, rcond=None)
    fixed, per_call, per_byte = (max(0.0, float(v))
                                 for v in (fixed, per_call, per_byte))
    return TransportProfile(
        name=name, per_call_s=per_call,
        bandwidth_Bps=1.0 / per_byte if per_byte > 0 else 1e15,
        fixed_s=fixed)


# -- compute: seconds = overhead + flops / effective_flops ----------------------
def fit_compute(samples: Sequence[Tuple[float, float]]
                ) -> Tuple[float, float]:
    """Fit (flops, seconds) samples; returns (effective_flops, overhead_s)."""
    if len(samples) < 2:
        raise ValueError(f"need >= 2 samples to fit 2 coefficients, "
                         f"got {len(samples)}")
    a = np.array([[1.0, f] for f, _ in samples])
    y = np.array([t for _, t in samples])
    (overhead, inv_eff), *_ = np.linalg.lstsq(a, y, rcond=None)
    overhead = max(0.0, float(overhead))
    eff = 1.0 / inv_eff if inv_eff > 0 else 1e18
    return float(eff), overhead


def fit_hardware(samples: Sequence[Tuple[float, float]],
                 base: HardwareProfile = TPU_V5E,
                 name: str = "fitted") -> HardwareProfile:
    """A HardwareProfile whose prefill_time() reproduces the samples.

    The fitted effective throughput lands in ``mfu_prefill`` (relative to
    ``base``'s peak), the fitted dispatch floor in ``step_overhead_s`` —
    i.e. exactly the two knobs ``predicted_ttft_s`` reads, so the
    controller's routing/admission estimates inherit the calibration
    unchanged.
    """
    eff, overhead = fit_compute(samples)
    return dataclasses.replace(base, name=name,
                               mfu_prefill=eff / base.peak_flops,
                               step_overhead_s=overhead)


# -- FLOP seeds -----------------------------------------------------------------
def prefill_flops(cfg, num_tokens: int, counts=None) -> float:
    """Prefill FLOPs for ``num_tokens``.

    Analytic model: the linear weight term (2 * active_params per token)
    PLUS the quadratic attention term (QK^T and AV are each
    2*n^2*heads*head_dim per layer), as the reference counts them (the
    causal mask's halving is not taken off). Where ``counts`` (an
    ``launch/op_counts.OpCounts`` of the prefill) is given, the larger of
    the two wins, as the reference refines its floor with the compiled
    HLO's count (``hlo_text``): the op count is exact where it sees the
    work, the analytic count a floor it only refines upward.
    """
    n_attn = cfg.num_attention_layers() or cfg.num_layers
    analytic = 2.0 * cfg.active_params() * num_tokens + \
        4.0 * n_attn * cfg.num_heads * cfg.head_dim * num_tokens ** 2
    if counts is not None:
        return max(analytic, float(counts.flops))
    return analytic


# -- the sweep ----------------------------------------------------------------
def measure_prefill(cfg, prompt_lens: Sequence[int] = CPU_PROMPT_LENS,
                    repeats: int = REPEATS, device=None
                    ) -> List[Tuple[float, float]]:
    """Time the port's single-sequence prefill at several prompt lengths.

    Params are built once from seed 0 on ``device`` (default: the GPU), in
    ``cfg``'s own dtype. Each length runs once to warm up
    and is then timed ``repeats`` times, keeping the MINIMUM wall — the
    estimator least contaminated by host noise. On a CUDA device the device
    is synchronized before and after each call, so a wall holds the whole
    prefill. Each length's FLOPs are :func:`prefill_flops` refined by the
    op count of the same prefill on ``meta``, as the reference refines them
    by the compiled prefill's HLO. Returns ``[(flops, best_seconds)]`` in
    ``prompt_lens`` order.
    """
    import torch

    from repro_torch import resolve_device
    from repro_torch.launch.op_counts import count
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    params = T.init_params(cfg, 0, dev)
    shapes = T.init_params(cfg, 0, "meta")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(tokens) -> float:
        sync()
        t0 = time.perf_counter()
        T.prefill(params, cfg, tokens)
        sync()
        return time.perf_counter() - t0

    samples = []
    with torch.inference_mode():
        for n in prompt_lens:
            tokens = torch.zeros((1, n), dtype=torch.int32, device=dev)
            _, counts = count(T.prefill, shapes, cfg, tokens.to("meta"))
            timed(tokens)                                 # warm-up
            best = min(timed(tokens) for _ in range(repeats))
            samples.append((prefill_flops(cfg, n, counts), best))
    return samples


# -- the sim-vs-real check -------------------------------------------------------
def check(bound: float = TTFT_ERROR_BOUND, arch: str = "qwen3-1.7b",
          device=None) -> dict:
    """Fit on the even sweep points, score prediction error on the odd ones.

    On the GPU the sweep takes the arch's full-size config at its own dtype
    and :data:`GPU_PROMPT_LENS`, and the fit starts from ``H100``; on the
    CPU the smoke config and :data:`CPU_PROMPT_LENS`, from ``TPU_V5E``.
    """
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config

    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    cfg = get_config(arch) if on_gpu else get_smoke_config(arch)
    lens = GPU_PROMPT_LENS if on_gpu else CPU_PROMPT_LENS
    samples = measure_prefill(cfg, lens, device=dev)
    train, held = samples[::2], samples[1::2]
    base = H100 if on_gpu else TPU_V5E
    hw = fit_hardware(train, base=base, name=f"{arch}-{dev.type}-fit")
    errors = []
    for flops, measured in held:
        pred = predicted_ttft_s(0.0, flops,
                                hw.peak_flops * hw.mfu_prefill,
                                hw.step_overhead_s)
        errors.append(abs(pred - measured) / measured)
    median = float(np.median(errors))
    return {
        "arch": arch,
        "device": str(dev),
        "config": cfg.name,
        "dtype": str(cfg.dtype),
        "base": base.name,
        "prompt_lens": list(lens),
        "samples": [list(s) for s in samples],
        "effective_flops": hw.peak_flops * hw.mfu_prefill,
        "mfu_prefill": hw.mfu_prefill,
        "step_overhead_s": hw.step_overhead_s,
        "held_out_rel_errors": errors,
        "median_rel_error": median,
        "bound": bound,
        "ok": median <= bound,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Calibrate cost-model coefficients from measured timings")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the fitted model predicts held-out "
                         f"prefill TTFT within {TTFT_ERROR_BOUND:.0%} "
                         "median relative error")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default="cuda",
                    help="where the prefill sweep runs (cpu: the smoke config)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    result = check(arch=args.arch, device=args.device)
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        print(f"calibrated {result['arch']} on {result['device']}: "
              f"effective {result['effective_flops']/1e9:.2f} GFLOP/s "
              f"(mfu_prefill {result['mfu_prefill']:.4f} of {result['base']}), "
              f"overhead {result['step_overhead_s']*1e3:.2f} ms, "
              f"median held-out TTFT error "
              f"{result['median_rel_error']:.1%} (bound {result['bound']:.0%})")
    if args.check and not result["ok"]:
        print(f"FAIL: median_rel_error {result['median_rel_error']:.3f} > "
              f"bound {result['bound']}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
