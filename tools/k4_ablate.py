#!/usr/bin/env python3
"""Attribute the time of K4's kernels on the card by ablation.

Each variant is ``src/repro_torch/csrc/flash_prefill.cu`` with one textual
change, compiled on its own (one ``nvcc`` per variant, all in parallel)
into ``build/k4_ablate/`` and timed through its ``flash_prefill_launch`` on
``chip_smoke.py``'s K4 shapes, beside SDPA on the same inputs, two rounds
in turn. Kernel times are device-only (torch.profiler, L2 flushed before
each call, 20 calls); SDPA's is a CUDA-event window (median of 20).

bf16 variants change the tensor-core kernel: the score scaling as an IEEE
division, one bf16 P, the fast exp, a skipped rescale, two q.k chains. Those
that change the arithmetic are timing probes only.

fp32 variants change the FMA kernel: the query tile (4, 2 or 1 warps a
block, the launch plan's choices), key tiles twice or half as wide, every
tile's loads waited for before its math (loads no longer overlap the
math), one K/V stage instead of two, the score scaling as an IEEE
division, registers capped for 12 warps an SM, launch bounds without a
minimum of blocks, p.V unrolled 2 instead of 4; timing probes that skip
q.k, the softmax or p.V (wrong results); and ``before``, the fp32 kernel
of an earlier ``flash_prefill.cu``
(``--before``: a file, or a git revision whose file is copied into the
build directory), so a speedup is measured on one card in one run. Each
fp32 variant's max |error| against the plain version is printed beside
its times.

    python3 tools/k4_ablate.py [--dtype bf16|fp32|both] [--before FILE_OR_REV]

Prints the card, ptxas's register and spill lines (every instantiation of
the unchanged kernels and of ``before``, hd 128 and fp32 hd 16 for the
other variants),
then one JSON line per (dtype, shape): ms per variant (both rounds).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/csrc/flash_prefill.cu"
OUT = ROOT / "build/k4_ablate"
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
KEYS_PER_SPLIT = 512
SOFTMAX_ARG = "s[j][2 * h + c]"
BF16_VARIANTS = {
    "kernel": [],
    # the score scaling as an IEEE division (range check and branch)
    "div_rn": [(f"div_sqrt_hd({SOFTMAX_ARG}, d, r)", f"__fdiv_rn({SOFTMAX_ARG}, d)")],
    # one bf16 P for p.V instead of P_hi + P_lo
    "one_bf16_p": [("      mma_bf16(o[2 * dn], pl[kk], bv[0], bv[1]);\n", ""),
                   ("      mma_bf16(o[2 * dn + 1], pl[kk], bv[2], bv[3]);\n", "")],
    # ex2.approx-based exp instead of the accurate expf
    "fast_exp": [(f"expf(__fsub_rn({SOFTMAX_ARG}, m_safe))",
                  f"__expf(__fsub_rn({SOFTMAX_ARG}, m_safe))")],
    # skip the accumulator rescale when every row's scale is exactly 1
    "skip_rescale": [("    m[h] = m_new;\n#pragma unroll\n    for (int n = 0; n < DT; ++n) {",
                      "    m[h] = m_new;\n    if (__any_sync(0xffffffffu, scale != 1.f))\n"
                      "#pragma unroll\n    for (int n = 0; n < DT; ++n) {")],
    # q.k in two accumulator chains (even and odd k16 steps), added at the end
    "split_qk": [("    uint32_t kf[2][NT / 2][4];\n",
                  "    float s2[NT][4] = {};\n    uint32_t kf[2][NT / 2][4];\n"),
                 ("mma_bf16(s[2 * nj], a,", "mma_bf16(((kk & 1) ? s2 : s)[2 * nj], a,"),
                 ("mma_bf16(s[2 * nj + 1], a,", "mma_bf16(((kk & 1) ? s2 : s)[2 * nj + 1], a,"),
                 ("    // -- online softmax; the mask-free path",
                  "#pragma unroll\n    for (int j = 0; j < NT; ++j)\n#pragma unroll\n"
                  "      for (int c = 0; c < 4; ++c) s[j][c] = __fadd_rn(s[j][c], s2[j][c]);\n"
                  "    // -- online softmax; the mask-free path")],
}
FP32_BK = "BK = HD <= 64 ? 64 : (HD == 128 ? 32 : 16);"
FP32_VARIANTS = {
    "kernel": [],
    "bk_wide": [(FP32_BK, "BK = HD <= 64 ? 128 : (HD == 128 ? 64 : 32);")],
    "bk_narrow": [(FP32_BK, "BK = HD <= 64 ? 32 : (HD == 128 ? 16 : 16);")],
    # wait for tile t+1's loads right after issuing them, before tile t's math
    "wait_each_tile": [("    cp_async_commit();\n    const int k0 = k_begin + t * BK;",
                        "    cp_async_commit();\n    cp_async_wait_all();\n"
                        "    const int k0 = k_begin + t * BK;")],
    "div_rn": [("div_sqrt_hd(s[a][c], d, r)", "__fdiv_rn(s[a][c], d)")],
    # at most 170 registers a thread, so three 4-warp blocks fit an SM
    "regs_12_warps": [("__launch_bounds__(NW * 32, 1)\nflash_prefill_fp32",
                       "__launch_bounds__(NW * 32, 12 / NW)\nflash_prefill_fp32")],
    # one K/V stage (a second barrier a tile, loads after the math)
    "single_stage": [
        ("return 4 * (2 * BK * 2 * HD", "return 4 * (BK * 2 * HD"),
        ("float* v_s = k_s + 2 * BK * HD; ", "float* v_s = k_s + BK * HD; "),
        ("float* p_s = v_s + 2 * BK * HD; ", "float* p_s = v_s + BK * HD; "),
        ("""    if (t + 1 < n_tiles)
      load_kv_tile_f32<HD, NTH>(k, v, kv_base, k_begin + (t + 1) * BK, Tk, KV,
                                k_s + ((t + 1) & 1) * BK * HD, v_s + ((t + 1) & 1) * BK * HD);
    cp_async_commit();
""", ""),
        ("    if (!warp_live || (causal && k0 > w_last_pos)) continue;   // adds exactly 0\n",
         "    if (warp_live && !(causal && k0 > w_last_pos)) {\n"),
        ("k_s + (t & 1) * BK * HD;", "k_s;"), ("v_s + (t & 1) * BK * HD;", "v_s;"),
        ("""    __syncwarp();
  }

  // -- one split""", """    __syncwarp();
    }
    __syncthreads();
    if (t + 1 < n_tiles)
      load_kv_tile_f32<HD, NTH>(k, v, kv_base, k_begin + (t + 1) * BK, Tk, KV, k_s, v_s);
    cp_async_commit();
  }

  // -- one split""")],
    # timing probes (wrong results): skip one phase of every tile
    "probe_no_qk": [("for (int j = 0; j < 8; ++j) {\n        const float* kr",
                     "for (int j = 0; j < 0; ++j) {\n        const float* kr")],
    "probe_no_softmax": [("    if (whole)\n      softmax_tile_f32",
                          "    for (int a = 0; a < TM; ++a) sc[a] = 1.f;\n"
                          "    if (k0 < 0) if (whole)\n      softmax_tile_f32")],
    # launch bounds without the minimum of one block (hd 16 then spills)
    "launch_bounds_default": [("__launch_bounds__(NW * 32, 1)\nflash_prefill_fp32",
                               "__launch_bounds__(NW * 32)\nflash_prefill_fp32")],
    "pv_unroll2": [("#pragma unroll 4\n    for (int j = 0; j < BK; ++j) {",
                    "#pragma unroll 2\n    for (int j = 0; j < BK; ++j) {")],
    "probe_no_pv": [("for (int j = 0; j < BK; ++j) {", "for (int j = 0; j < 0; ++j) {")],
    # 8-warp blocks with 64-key tiles at hd 128 (one block an SM)
    "nw8_bk64": [(FP32_BK, "BK = HD <= 64 ? 64 : (HD == 128 ? 64 : 16);"),
                 ("      if constexpr (HD == 256) { K4_FP32(8); }", "      K4_FP32(8);")],
    # probes of what is left: launch and grid only; no K/V loads after the
    # first tile; every tile written out as if it had one split (no
    # partials, tickets or combine)
    "probe_empty": [("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
                     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
                     "  if (n_tiles > 0) return;\n")],
    "probe_no_loads": [("""    if (t + 1 < n_tiles)
      load_kv_tile_f32<HD, NTH>(k, v, kv_base, k_begin + (t + 1) * BK, Tk, KV,
                                k_s + ((t + 1) & 1) * BK * HD, v_s + ((t + 1) & 1) * BK * HD);
""", "")],
    "probe_no_combine": [("  if (ns_tile == 1) {", "  if (ns_tile >= 1) {")],
    # the reduce-scatter with selects (slot j holds key j on every lane)
    "scatter_select": [
        ("const float* kr = ks + (8 * c + (j ^ kg)) * HD + kg * DV;",
         "const float* kr = ks + (8 * c + j) * HD + kg * DV;"),
        ("""#pragma unroll
  for (int i = 0; i < 4; ++i) h4[i] = __fadd_rn(x[i], __shfl_xor_sync(0xffffffffu, x[4 + i], 4));
#pragma unroll
  for (int i = 0; i < 2; ++i) h2[i] = __fadd_rn(h4[i], __shfl_xor_sync(0xffffffffu, h4[2 + i], 2));
  return __fadd_rn(h2[0], __shfl_xor_sync(0xffffffffu, h2[1], 1));""",
         """  const int kg = threadIdx.x & 7;
  const bool b4 = kg & 4, b2 = kg & 2, b1 = kg & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h4[i] = __fadd_rn(b4 ? x[4 + i] : x[i], __shfl_xor_sync(0xffffffffu, b4 ? x[i] : x[4 + i], 4));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    h2[i] = __fadd_rn(b2 ? h4[2 + i] : h4[i], __shfl_xor_sync(0xffffffffu, b2 ? h4[i] : h4[2 + i], 2));
  return __fadd_rn(b1 ? h2[1] : h2[0], __shfl_xor_sync(0xffffffffu, b1 ? h2[0] : h2[1], 1));""")],
    # the combine reading one split at a time
    "combine_serial": [("    const float* pp = pt + p * PF;\n    // four splits' loads at a time, summed in split order\n    float mx = -FLT_MAX;\n    for (int s0 = 0; s0 < nr; s0 += 4) {\n#pragma unroll\n      for (int u = 0; u < 4; ++u)\n        if (s0 + u < nr) mx = fmaxf(mx, __ldcg(pp + (s0 + u) * ss + HD));\n    }\n    const float ms = isfinite(mx) ? mx : 0.f;\n    float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};\n    for (int s0 = 0; s0 < nr; s0 += 4) {\n      float m_s[4], l_s[4];\n      float4 x[4];\n#pragma unroll\n      for (int u = 0; u < 4; ++u) {\n        if (s0 + u >= nr) continue;\n        const float* ps = pp + (s0 + u) * ss;\n        m_s[u] = __ldcg(ps + HD);\n        l_s[u] = __ldcg(ps + HD + 1);\n        x[u] = __ldcg(reinterpret_cast<const float4*>(ps + c4));\n      }\n#pragma unroll\n      for (int u = 0; u < 4; ++u) {\n        if (s0 + u >= nr) continue;\n        const float w = isfinite(m_s[u]) ? expf(__fsub_rn(m_s[u], ms)) : 0.f;\n        const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};\n        if (s0 + u == 0) {\n          lsum = __fmul_rn(l_s[u], w);\n#pragma unroll\n          for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(xs[e], w);\n        } else {\n          lsum = __fadd_rn(lsum, __fmul_rn(l_s[u], w));\n#pragma unroll\n          for (int e = 0; e < 4; ++e) o[e] = __fadd_rn(o[e], __fmul_rn(xs[e], w));\n        }\n      }\n    }\n",
                        '    const float* pp = pt + p * PF;\n    float mx = __ldcg(pp + HD);\n    for (int s = 1; s < nr; ++s) mx = fmaxf(mx, __ldcg(pp + s * ss + HD));\n    const float ms = isfinite(mx) ? mx : 0.f;\n    float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};\n    for (int s = 0; s < nr; ++s) {\n      const float m_s = __ldcg(pp + s * ss + HD);\n      const float w = isfinite(m_s) ? expf(__fsub_rn(m_s, ms)) : 0.f;\n      const float l_s = __ldcg(pp + s * ss + HD + 1);\n      const float4 x = __ldcg(reinterpret_cast<const float4*>(pp + s * ss + c4));\n      const float xs[4] = {x.x, x.y, x.z, x.w};\n      if (s == 0) {\n        lsum = __fmul_rn(l_s, w);\n#pragma unroll\n        for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(xs[e], w);\n      } else {\n        lsum = __fadd_rn(lsum, __fmul_rn(l_s, w));\n#pragma unroll\n        for (int e = 0; e < 4; ++e) o[e] = __fadd_rn(o[e], __fmul_rn(xs[e], w));\n      }\n    }\n')],
    # the score chunks unrolled (the compiler holds every chunk's partials)
    "chunks_unrolled": [("#pragma unroll 1\n    for (int c = 0; c < TN; ++c) {",
                         "#pragma unroll\n    for (int c = 0; c < TN; ++c) {")],
}
# what is left with no q.k, softmax or p.V at all
FP32_VARIANTS["probe_base"] = (FP32_VARIANTS["probe_no_qk"] + FP32_VARIANTS["probe_no_softmax"]
                               + FP32_VARIANTS["probe_no_pv"])
# (tag, S, q_offset, H, KV, hd): chip_smoke's K4 cases (bf16 also a G = 8, hd 64 one)
SHAPES = [("cold", 1500, 0, 16, 8, 128), ("suffix", 400, 1056, 16, 8, 128),
          ("cold gemma-2b heads", 1024, 0, 8, 1, 256)]
BF16_SHAPES = SHAPES + [("cold hd 64 G 8", 700, 0, 32, 4, 64)]
_VP, _I = ctypes.c_void_p, ctypes.c_int
NEW_ARGS = [_VP] * 4 + [_I] * 12 + [_VP] * 3
OLD_ARGS = [_VP] * 4 + [_I] * 9 + [_VP]


def ptxas_lines(log: str, every: bool) -> dict:
    """kernel instantiation -> ptxas's spill and register lines; only the
    hd-128 ones (NG 2 / NW 4) unless ``every``."""
    pats = [(r"flash_prefill_mma_kernelILi(\d+)ELi(\d+)E", "bf16 hd {}, NG {}"),
            (r"flash_prefill_fp32_kernelILi(\d+)ELi(\d+)E", "fp32 hd {}, NW {}"),
            (r"flash_prefill_kernelIfLi(\d+)E", "fp32 hd {}")]
    wanted = ("bf16 hd 128, NG 2", "fp32 hd 128, NW 4", "fp32 hd 16, NW 4", "fp32 hd 128")
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            key = None
            for pat, fmt in pats:
                m = re.search(pat, ln)
                if m:
                    key = fmt.format(*m.groups())
                    break
            key = key if key and (every or key in wanted) else None
        elif key and ("spill" in ln or "registers" in ln):
            out.setdefault(key, []).append(ln.replace("ptxas info    :", "").strip())
    return out


def before_source(spec: str) -> str:
    path = pathlib.Path(spec)
    if path.is_file():
        return path.read_text()
    rel = SRC.relative_to(ROOT).as_posix()
    got = subprocess.run(["git", "-C", str(ROOT), "show", f"{spec}:{rel}"],
                         capture_output=True, text=True)
    if got.returncode:
        raise SystemExit(f"k4_ablate: --before {spec!r} is neither a file nor a revision "
                         f"holding {rel}: {got.stderr.strip()}")
    return got.stdout


def build(variants: dict, before: str | None) -> dict:
    """Compile every variant (and ``before``) in parallel; name -> launch fn."""
    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    texts = {}
    for name, edits in variants.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k4_ablate: variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    if before is not None:
        texts["before"] = before
    procs = {}
    for name, text in texts.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([*NVCC, "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_ablate: nvcc failed on {name}:\n{log}")
        print(name, json.dumps(ptxas_lines(log, every=name in ("kernel", "before"))), flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_prefill_launch
        fn.argtypes = OLD_ARGS if name == "before" else NEW_ARGS
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def fp32_grid(s: int, t: int, H: int, KV: int, hd: int, nw: int) -> tuple:
    """(query tiles, key splits) of the fp32 kernel at nw warps a block."""
    wp = 16 if hd <= 128 else 8
    rows = nw * wp // (H // KV)
    return -(-s // rows), -(-t // KEYS_PER_SPLIT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "fp32", "both"), default="both")
    ap.add_argument("--before", default=None,
                    help="an earlier flash_prefill.cu (file or git revision) whose fp32 "
                         "kernel is timed as 'before'")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k4_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.flash_prefill.ops import launch_plan
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    do_bf16, do_fp32 = args.dtype in ("bf16", "both"), args.dtype in ("fp32", "both")
    variants = dict(BF16_VARIANTS) if do_bf16 else {}
    if do_fp32:
        variants.update({("fp32_" + k if k != "kernel" else k): v
                         for k, v in FP32_VARIANTS.items()})
    fns = build(variants, before_source(args.before) if do_fp32 and args.before else None)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def dev_ms(call):
        return cs.device_only_ms(torch, call, "flash_prefill", flush=flush)

    def check(err):
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    if do_bf16:
        bf16_fns = {n: f for n, f in fns.items() if n in BF16_VARIANTS}
        for tag, s, off, H, KV, hd in BF16_SHAPES:
            t = s + off
            mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
            q, k, v = mk(1, s, H, hd), mk(1, t, KV, hd), mk(1, t, KV, hd)
            out = torch.empty_like(q)
            row = {"dtype": "bf16", "shape": tag,
                   "sdpa_ms": cs.time_ms(torch, cs._sdpa(torch, q, k, v, off), flush=flush)}
            for _ in range(2):
                for name, fn in bf16_fns.items():
                    def call(fn=fn):
                        check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, s,
                                 t, H, KV, hd, off, 1, 1, 0, 0, 0, None, None, stream()))
                    row.setdefault(name, []).append(dev_ms(call))
            print(json.dumps(row), flush=True)
    if not do_fp32:
        return 0
    for tag, s, off, H, KV, hd in SHAPES:
        t = s + off
        mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
        q, k, v = mk(1, s, H, hd), mk(1, t, KV, hd), mk(1, t, KV, hd)
        want = flash_prefill_ref(q, k, v, q_offset=off)
        plan = launch_plan(1, s, t, H, KV, hd, True, sms)
        wp = 16 if hd <= 128 else 8
        widths = [nw for nw in (4, 2, 1) if nw * wp >= H // KV]
        nq_max = max(fp32_grid(s, t, H, KV, hd, nw)[0] * nw * wp for nw in widths + [8])
        part = torch.empty(nq_max * KV * -(-t // KEYS_PER_SPLIT) * (hd + 4), device="cuda")
        runs = {}
        for name, fn in fns.items():
            if name == "before":
                runs[name] = lambda fn=fn, o=None: fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, s, t, H, KV, hd,
                    off, 1, 0, stream())
            elif name == "kernel" or name.startswith("fp32_"):
                fixed = [8] if "nw8" in name else [plan["warps"]]
                for nw in (widths if name == "kernel" else fixed):
                    nq, ns = fp32_grid(s, t, H, KV, hd, nw)
                    label = f"kernel_nw{nw}" if name == "kernel" else name
                    runs[label] = lambda fn=fn, o=None, nw=nw, nq=nq, ns=ns: fn(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, s, t, H, KV,
                        hd, off, 1, 0, nw, nq, ns, part.data_ptr(), tickets.data_ptr(),
                        stream())
        row = {"dtype": "fp32", "shape": tag, "plan": plan,
               "sdpa_ms": cs.time_ms(torch, cs._sdpa(torch, q, k, v, off), flush=flush),
               "max_abs_err": {}}
        for name, run in runs.items():
            out = torch.empty_like(q)
            check(run(o=out))
            torch.cuda.synchronize()
            row["max_abs_err"][name] = float((out - want).abs().max())
        for _ in range(2):
            for name, run in runs.items():
                out = torch.empty_like(q)
                row.setdefault(name, []).append(dev_ms(lambda run=run, out=out: check(run(o=out))))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
