#!/usr/bin/env python3
"""Time K1's host route (``csrc/kv_transfer.cu``) on the card, with
one-change variants of its source.

The host tier moves whole blocks between a CUDA pool and a pinned host
pool: demote (card -> host, the SMs write over PCIe) and promote (host ->
card, the SMs read over PCIe). This tool times both on ``chip_smoke.py``'s
tier shape (the 33 blocks of a 1056-token qwen3-1.7b prefix in float32,
1848 pages of 128 KiB, 242 MB) for each variant, beside the PyTorch calls
that make the same move on the copy engines (``index_select`` + ``copy_``
into pinned memory, and the reverse) and a plain contiguous ``copy_`` of
the same bytes each way. Each variant is compiled on its own (one ``nvcc``
per variant, in parallel) into ``build/k1_host_ablate/``, launched through
the wrapper, held bit-exact against the plain version, and also timed on
K1's device-to-device case (chip_smoke's 1000-token bf16 P->D table, L2
flushed), so a change that helps the host route but costs HBM shows.

    python3 tools/k1_host_ablate.py     # on a machine with an H100 and nvcc

Prints the nvidia-smi name and power limit, then one JSON line per round
(CUDA events, median of 10 calls a case).
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/csrc/kv_transfer.cu"
OUT = ROOT / "build/k1_host_ablate"

LOOP = """  long long base = threadIdx.x;
  for (; base + (kUnroll - 1) * kThreads < n; base += step) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[base + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[base + u * kThreads] = v[u];
  }
  for (long long j = base; j < n; j += kThreads) d[j] = s[j];"""
# each warp's kUnroll loads cover one contiguous run of 32 * kUnroll words
WARP_CONTIG = """  const long long own = (long long)(threadIdx.x >> 5) * 32 * kUnroll + (threadIdx.x & 31);
  long long c = 0;
  for (; c + step <= n; c += step) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[c + own + u * 32];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[c + own + u * 32] = v[u];
  }
  for (long long j = c + threadIdx.x; j < n; j += kThreads) d[j] = s[j];"""
KERNEL = "template <typename W>\n__global__ void kv_transfer_kernel("
HINT = """template <typename W>
__device__ __forceinline__ W ld_hint(const W* p) { return *p; }
template <>
__device__ __forceinline__ uint4 ld_hint<uint4>(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

"""
DST_LINE = "  W* d = reinterpret_cast<W*>(dst + (long long)dst_pages[i] * row_bytes);\n"
PREFETCH = DST_LINE + """  if (sizeof(W) == 16 && threadIdx.x == 0)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(s), "r"((unsigned)row_bytes) : "memory");
"""
VARIANTS = {
    "kernel": [],
    "unroll_8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "unroll_16": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 16;")],
    "threads_512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "no_nc": [("const char* __restrict__ src,", "const char* src,")],
    "warp_contig": [(LOOP, WARP_CONTIG)],
    "warp_contig_unroll_8": [(LOOP, WARP_CONTIG),
                             ("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "l2_256b": [(KERNEL, HINT + KERNEL),
                ("v[u] = s[base + u * kThreads];", "v[u] = ld_hint(s + base + u * kThreads);")],
    "bulk_prefetch": [(DST_LINE, PREFETCH)],
}


def build_variants(nvcc_flags, signatures) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k1_host_ablate: variant {name}: the source no longer has "
                                 f"{old[:60]!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-shared", "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k1_host_ablate: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in ("kv_transfer_launch", "kv_transfer_host_launch"):
            getattr(lib, fn).argtypes = signatures[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k1_host_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.layout import KVCacheSpec
    from repro_torch.core.transfer import TransferPlanner
    from repro_torch.kernels import build
    from repro_torch.kernels.kv_gather import kv_transfer, kv_transfer_ref
    from repro_torch.serving.kv_cache import spec_for_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    build.library()
    shipped = build._LIB
    libs = build_variants(build.NVCC_FLAGS, build._SIGNATURES)
    cfg = dataclasses.replace(get_config(cs.ARCH), dtype=torch.float32)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    # the host route on the tier's shape (fp32)
    spec = spec_for_model(cfg, 64)
    pool = torch.randn(spec.shape, generator=gen, device=dev)
    back = torch.zeros_like(pool)
    host = torch.empty(spec.shape, dtype=spec.dtype, pin_memory=True)
    n = cs.PREFIX_LEN // spec.block_size
    blocks, hb = list(range(5, 5 + n)), list(range(20, 20 + n))
    planner = TransferPlanner(spec)

    def pages(plan, side):
        return torch.as_tensor(plan.to_descriptors().page_ids(spec, side),
                               dtype=torch.int32).to(dev)

    down, up = planner.plan("flowkv", blocks, hb), planner.plan("flowkv", hb, blocks)
    dsp, ddp, usp, udp = pages(down, "src"), pages(down, "dst"), pages(up, "src"), pages(up, "dst")
    nbytes = int(dsp.numel()) * spec.payload * 4
    ids = torch.as_tensor(blocks, device=dev)
    hview = host[20:20 + n]
    dev_contig = pool[5:5 + n].clone()
    # the device-to-device case: chip_smoke's 1000-token bf16 P->D table
    dspec = KVCacheSpec(num_layers=cfg.num_layers, num_blocks=256, block_size=cfg.block_size,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                        dtype=torch.bfloat16)
    dsrc = torch.randn(dspec.shape, generator=gen, device=dev).to(torch.bfloat16)
    ddst = torch.zeros_like(dsrc)
    _, sp, dp = cs._transfer_case(torch, dspec, 256, 1000, gen)

    for name, lib in libs.items():             # bit-exact first, every variant
        build._LIB = lib
        host.zero_()
        back.zero_()
        kv_transfer(pool, host, dsp, ddp)
        kv_transfer(host, back, usp, udp)
        torch.cuda.synchronize()
        want = torch.zeros_like(pool)          # the pages the round trip did not name stay 0
        want[blocks] = pool[blocks]
        cs.check(torch.equal(back.view(torch.int32), want.view(torch.int32)),
                 f"k1_host_ablate: {name} round trip not bit-exact")
        ddst.zero_()
        kv_transfer(dsrc, ddst, sp, dp)
        ref = torch.zeros_like(dsrc)
        kv_transfer_ref(dsrc, ref, sp, dp)
        torch.cuda.synchronize()
        cs.check(torch.equal(ddst.view(torch.int16), ref.view(torch.int16)),
                 f"k1_host_ablate: {name} device-to-device not bit-exact")
    build._LIB = shipped
    print(json.dumps({"bytes": nbytes, "pages": int(dsp.numel()), "blocks": n}), flush=True)
    for rnd in range(2):
        row = {"round": rnd, "unit": "ms"}
        row["library demote (index_select + copy_)"] = cs.time_ms(
            torch, lambda: hview.copy_(pool.index_select(0, ids), non_blocking=True), reps=10)
        row["library promote (copy_ + index_copy_)"] = cs.time_ms(
            torch, lambda: back.index_copy_(0, ids, hview.to(dev, non_blocking=True)), reps=10)
        row["contiguous copy_ card->host"] = cs.time_ms(
            torch, lambda: hview.copy_(dev_contig, non_blocking=True), reps=10)
        row["contiguous copy_ host->card"] = cs.time_ms(
            torch, lambda: dev_contig.copy_(hview, non_blocking=True), reps=10)
        for name, lib in libs.items():
            build._LIB = lib
            row[f"{name} demote"] = cs.time_ms(torch, lambda: kv_transfer(pool, host, dsp, ddp),
                                               reps=10)
            row[f"{name} promote"] = cs.time_ms(torch, lambda: kv_transfer(host, back, usp, udp),
                                                reps=10)
            row[f"{name} device P->D 1000 bf16"] = cs.time_ms(
                torch, lambda: kv_transfer(dsrc, ddst, sp, dp), flush=flush)
        build._LIB = shipped
        row["bound_ms gen5 x16"] = nbytes / (16 * cs.PCIE_LANE_BPS[5]) * 1e3
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
