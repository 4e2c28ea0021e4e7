#!/usr/bin/env python3
"""Attribute the time of K3 (paged decode attention) on the card.

Runs ``chip_smoke.py``'s K3 cases (qwen3-1.7b's heads over one layer of a
28-layer pool: B=1 at 2000 tokens, B=8 up to 2047 with a length-0 row, and
the e2e decode step's B=4 at 200/640/1100/1500; table width 64) in
bfloat16 and float32, in two parts:

1. The split length: ``ops.PAGES_PER_SPLIT`` set to n = 2, 4, 8 in turn
   (the wrapper reads it at each call), each first held to the plain version on the upcast
   values (fp32 1e-4, bf16 2^-7), then timed in turn, two rounds (CUDA
   events, L2 flushed, median of 20), and device-only (the kernel's own
   time from torch.profiler over 20 calls, without the wrapper's host work).
2. One-change variants of ``src/repro_torch/csrc/paged_attention.cu``, each
   compiled on its own (one ``nvcc`` per variant, in parallel) into
   ``build/k3_ablate/`` and launched through the wrapper, device-only, two
   rounds. Variants that skip work (``no_combine``, ``no_loop``,
   ``no_loop_no_combine``, ``all_empty``) are timing probes whose results
   are wrong and not checked; they split the time into the launch, each
   block's fixed chain, the token loop and the combine.

    python3 tools/k3_ablate.py          # on a machine with an H100 and nvcc

Prints the nvidia-smi name and power limit, each variant's ptxas register
line for the bf16 kernel at qwen3-1.7b's shape, then one JSON line per case
and part.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/csrc/paged_attention.cu"
OUT = ROOT / "build/k3_ablate"
SPLITS = (2, 4, 8)
LOOP = "for (int c = warp; c < n_chunks; c += kWarps) {"
COMBINE = "  if (!last_block) return;"
VARIANTS = {
    "kernel": [],
    # 4 warps a block instead of 8
    "warps_4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    # registers capped for 3 blocks an SM
    "launch_bounds_3": [("__global__ void __launch_bounds__(kThreads)",
                         "__global__ void __launch_bounds__(kThreads, 3)")],
    # the combine's loads 16 a thread in flight instead of 4
    "combine_unroll_16": [("#pragma unroll 4\n", "#pragma unroll 16\n")],
    # timing probes (wrong results)
    "no_combine": [(COMBINE, "  return;")],
    "no_loop": [(LOOP, LOOP.replace("c < n_chunks", "c < 0"))],
    "no_loop_no_combine": [(LOOP, LOOP.replace("c < n_chunks", "c < 0")), (COMBINE, "  return;")],
    "all_empty": [("  if (split >= n_splits) {", "  if (true) {")],
}
CHECKED = ("kernel", "warps_4", "launch_bounds_3", "combine_unroll_16")


def build_variants(nvcc_flags, signatures, restypes) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k3_ablate: variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-shared", "-Xptxas", "-v",
             "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k3_ablate: nvcc failed on {name}:\n{log}")
        main_kernel = False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                main_kernel = "paged_decode_split_kernelI13__nv_bfloat16Li2ELi2E" in ln
            elif main_kernel and ("registers" in ln or "spill" in ln):
                print(name, ln.replace("ptxas info    :", "").strip(), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn, argtypes in signatures.items():
            if fn.startswith("paged_decode"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restypes.get(fn, ctypes.c_int)
        libs[name] = lib
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k3_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch import kernels
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import (ops, paged_decode_attention,
                                                     paged_decode_attention_stats_ref)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    build.library()
    shipped = build._LIB
    libs = build_variants(build.NVCC_FLAGS, build._SIGNATURES, build._RESTYPES)
    cfg = get_config(cs.ARCH)
    L, KV, hd, bs, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.block_size, cfg.num_heads
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    nb, layer = 512, L * 3 // 5
    kept = ops.PAGES_PER_SPLIT
    for dtype in (torch.bfloat16, torch.float32):
        pool = torch.randn((nb, L, 2, bs * KV * hd), generator=gen, device="cuda").to(dtype)
        tol = cs.FP32_TOL if dtype == torch.float32 else cs.BF16_UPCAST_TOL
        for B, lens, W in cs.K3_CASES:
            q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
            bt = torch.stack([torch.randperm(nb, generator=gen, device="cuda")[:W]
                              for _ in range(B)]).to(torch.int32)
            for i, ln in enumerate(lens):
                bt[i, -(-ln // bs):] = 0
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            want, _, _ = paged_decode_attention_stats_ref(q.float(), pool[:, layer].float(), bt,
                                                          lengths, bs)
            head = {"dtype": str(dtype), "batch": B, "lengths": lens, "table_width": W}

            def call(n=kept):
                ops.PAGES_PER_SPLIT = n
                try:
                    return paged_decode_attention(q, pool, layer, bt, lengths, block_size=bs,
                                                  return_stats=True)
                finally:
                    ops.PAGES_PER_SPLIT = kept

            # part 1: pages per split, through the shipped kernel
            build._LIB = shipped
            row = dict(head, part="pages_per_split")
            for n in SPLITS:
                err = float((call(n)[0].float() - want).abs().max())
                cs.check(err <= tol, f"k3_ablate: {n} pages per split off by {err}")
            for _ in range(2):
                for n in SPLITS:
                    row.setdefault(f"ms {n}", []).append(
                        cs.time_ms(torch, lambda n=n: call(n), flush=flush))
            for n in SPLITS:
                row[f"device_only_ms {n}"] = cs.device_only_ms(
                    torch, lambda n=n: call(n), "paged_decode", flush=flush)
            print(json.dumps(row), flush=True)
            # part 2: one-change variants, device-only
            row = dict(head, part="variants (device-only ms)")
            for rnd in range(2):
                for name, lib in libs.items():
                    build._LIB = lib
                    kernels._TICKETS.clear()   # a probe may leave its tickets set
                    if rnd == 0 and name in CHECKED:
                        err = float((call()[0].float() - want).abs().max())
                        cs.check(err <= tol, f"k3_ablate: variant {name} off by {err}")
                    row.setdefault(name, []).append(
                        cs.device_only_ms(torch, call, "paged_decode", flush=flush))
            kernels._TICKETS.clear()
            build._LIB = shipped
            print(json.dumps(row), flush=True)
        del pool
    return 0


if __name__ == "__main__":
    sys.exit(main())
