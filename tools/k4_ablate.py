#!/usr/bin/env python3
"""Attribute the time of K4's bf16 kernel on the card by ablation.

Each variant is ``src/repro_torch/csrc/flash_prefill.cu`` with one textual
change, compiled on its own (one ``nvcc`` per variant, all in parallel)
into ``build/k4_ablate/`` and timed through its ``flash_prefill_launch`` on
``chip_smoke.py``'s K4 shapes (CUDA events, L2 flushed, median of 20, two
rounds in turn), beside SDPA on the same inputs. Variants that change the
arithmetic (``one_bf16_p``, ``fast_exp``) are timing probes only: their
results are not checked.

    python3 tools/k4_ablate.py          # on a machine with an H100 and nvcc

Prints ptxas's register and spill lines of the bf16 kernel (every
instantiation for the unchanged kernel, hd 128 for the variants), then one
JSON line per shape: ms per variant (both rounds) and SDPA's ms.
"""
from __future__ import annotations

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
SOFTMAX_ARG = "s[j][2 * h + c]"
VARIANTS = {
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
# (tag, S, q_offset, H, KV, hd): chip_smoke's K4 cases plus a G = 8, hd 64 one
SHAPES = [("cold", 1500, 0, 16, 8, 128), ("suffix", 400, 1056, 16, 8, 128),
          ("cold gemma-2b heads", 1024, 0, 8, 1, 256), ("cold hd 64 G 8", 700, 0, 32, 4, 64)]


def ptxas_lines(log: str, every: bool) -> dict:
    """(hd, pair groups) -> ptxas's spill and register lines for the bf16
    kernel; only hd 128 with 2 groups unless ``every``."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"flash_prefill_mma_kernelILi(\d+)ELi(\d+)E", ln)
            key = f"hd {m.group(1)}, NG {m.group(2)}" if m else None
            key = key if every or key == "hd 128, NG 2" else None
        elif key and ("spill" in ln or "registers" in ln):
            out.setdefault(key, []).append(ln.replace("ptxas info    :", "").strip())
    return out


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k4_ablate: variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([*NVCC, "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_ablate: nvcc failed on {name}:\n{log}")
        print(name, json.dumps(ptxas_lines(log, every=name == "kernel")), flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_prefill_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    fns = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for tag, s, off, H, KV, hd in SHAPES:
        t = s + off
        mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
        q, k, v = mk(1, s, H, hd), mk(1, t, KV, hd), mk(1, t, KV, hd)
        out = torch.empty_like(q)
        row = {"shape": tag, "sdpa_ms": cs.time_ms(torch, cs._sdpa(torch, q, k, v, off), flush=flush)}
        for _ in range(2):
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, s, t,
                             H, KV, hd, off, 1, 1, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: cudaError_t {err}")
                row.setdefault(name, []).append(cs.time_ms(torch, call, flush=flush))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
