#!/usr/bin/env python3
"""Drive the PyTorch port's FlowKV P->D serving path on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits nonzero):

1. ``env``     — the card (name and power limit from nvidia-smi, capability
                 9.0 required), torch and CUDA versions.
2. ``build``   — compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a).
3. ``kernels`` — each hand-written kernel against its plain PyTorch version
                 on the card at the main path's shapes (qwen3-1.7b: L=28,
                 KV=8, hd=128, block 32): K1 on a 1000-token P->D transfer
                 table and on a B=8 decode append (bit-exact, plus the
                 kernel's own device time from torch.profiler), K3 at B=1,
                 at B=8 with lengths up to ~2k, a padded table and a
                 length-0 row, and at the e2e decode step's B=4, in float32
                 and bfloat16 (stated tolerances), each B=8 row bit-identical
                 to the same row alone at B=1;
                 K4 cold (S = T = 1500), suffix (S = 400 at q_offset 1056)
                 and at gemma-2b's head shape, in both dtypes (bf16 on the
                 tensor cores; fp32 with its launch plan and its share of
                 the FMA bound), sim_calibrate's bf16 shapes (cold 4096
                 and 256, suffix 200 at q_offset 1056), plus its suffix rows bit-identical to its
                 cold rows in fp32 and in bf16; K5a (33-block gather, its
                 own block copy) and K5b (47-block scatter), bit-exact, K5b
                 also timed device-only; kernel, plain, bound and library
                 times.
4. ``e2e_fp32`` — FlowKVClient on full-width, full-depth qwen3-1.7b in
                 float32 (1 prefill + 1 decode node, 256 blocks, 4 prompts
                 of 200-1500 tokens, 16 new tokens each): tokens identical
                 to the port's monolithic greedy_generate, one transfer
                 dispatch per plan, decode_dispatches == decode_steps,
                 checksums pass, K1/K3 launched.
5. ``e2e_bf16`` — the same at the config's own bfloat16: first tokens equal
                 to monolithic prefill, one paged step's logits within a
                 stated tolerance of the dense step on the same state, full
                 token agreement reported; TTFT, transfer and per-step decode
                 wall times, K3's device time and share of the step; the
                 device-time split (GEMMs, K4, K5b, rest) of
                 one cold prefill of the 1500-token prompt with its pool
                 write. This run is the main path whose K1, K3 and bf16 K4
                 launch counts go into the ``kernels`` line.
6. ``e2e_prefix`` — the prefill data plane on full-width, full-depth
                 qwen3-1.7b in float32: a 1056-token shared prefix, a donor
                 and three followers served on 1P+1D with prefix reuse and
                 layer_window=7, again with reuse off, again chunked, and by
                 monolithic greedy_generate — identical tokens, exact reuse
                 accounting, one dispatch per prefix fetch and per window
                 sub-plan, no leaks; K4 (cold and suffix), K5a and K5b
                 launched (their counts, fp32 K4's among them, go into the
                 ``kernels`` line). TTFT
                 split and the prefill's device time by kernel are printed.
7. ``e2e_faults_tier`` — the fault plane, the serving checkpoint and the
                 host-DRAM tier on full-width, full-depth qwen3-1.7b in
                 float32, 1 prefill + 2 decode nodes: a corrupted P->D
                 transfer caught by the device verify and repaired by the
                 retry, a transfer failing every attempt degraded to
                 recompute, a decode node killed mid-decode (each token
                 streamed exactly once), all token-identical to monolithic
                 greedy_generate; save_cluster mid-stream, load_cluster into
                 a fresh cluster, finish with the same tokens; a 1056-token
                 prefix demoted to a pinned host tier by unrelated prompts
                 and promoted for a follower in one K1 launch, tokens equal
                 to the run without a tier and to monolithic, exact reuse
                 accounting, both tiers' invariants. Prints one 1500-token
                 transfer's K1 time, device verify wall and host blake2b
                 wall, and K1's demote/promote times over pinned memory
                 against the host link's bound (nvidia-smi) and the PyTorch
                 calls that make the same move; its host-route launch count
                 goes into the ``kernels`` line as ``kv_transfer_host``.
8. ``sim_calibrate`` — the simulator's H100 profile fitted from the port's
                 own prefill (``obs/calibrate.check`` on the card):
                 full-width, full-depth qwen3-1.7b at its bfloat16, 8 prompt
                 lengths from 256 to 4096 (the half above flash_threshold
                 launches K4; its launches are counted and checked), the
                 wall fitted on the even lengths and scored on the odd ones
                 against the reference's 0.75 median bound, and reported as
                 degenerate where it is not physical; each length's wall
                 beside the stock profile's price and its device time by
                 part, the device time fitted the same way, which must be
                 physical (a positive slope, at most the peak). Then the
                 tier run on 1P+1D (48 pool and 128 pinned host blocks, a
                 1056-token prefix, one churn prompt, a follower) served on
                 the card and simulated by ClusterSim under the same
                 weakened router: the follower's reuse, the prefix fetches
                 and the tier_demote / tier_promote span stream must be
                 equal, with K1 (transfer, append, host route), K3, K4
                 (cold and suffix), K5a and K5b launched. K4's shapes in
                 this phase (cold 4096 and 256, suffix 200 over 1256, bf16)
                 are held against its plain version in the kernels phase.

The weights are random, made from a seed. The last lines are the kernels
summary, the nvidia-smi line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"          # every phase runs on the card; without one the script stops
ARCH = "qwen3-1.7b"
# fp32 parity of a kernel vs its plain version: summation order differs, so
# hold max |delta| to 1e-4 absolute (scores are O(10), outputs O(1)).
FP32_TOL = 1e-4
# bf16 kernel vs plain version on the same bf16 inputs: the plain version
# rounds q.k to bf16 before the softmax (8-bit mantissa), so hold outputs to
# 2e-2 as the reference's own bf16 kernel tests do, and m to 5e-2 absolute.
# At a 2k context |out| is itself ~0.03, so this limit alone would pass a
# wrong kernel: the checks that fail one are the upcast limit below and the
# 1e-4 limits on m and l against the upcast plain version.
BF16_TOL = 2e-2
# bf16 kernel vs plain version on the same values upcast to fp32 (exact):
# only the summation order and the final bf16 rounding of out differ, so
# out is held to one bf16 ulp at |x| <= 2 (2^-7) and m, l to 1e-4 relative.
BF16_UPCAST_TOL = 2.0 ** -7
# K4 vs its plain version: fp32 within the reference's own 2e-5 (only the
# summation order differs); bf16 within its 3e-2 against the plain version
# on the same bf16 values (which rounds the softmax weights to bf16), and
# within half a bf16 ulp (|x| * 2^-8) + 1e-5 of the plain version on the
# same values upcast to fp32 (only the final rounding of out differs).
K4_FP32_TOL = 2e-5
K4_BF16_TOL = 3e-2
# bf16 paged decode step vs dense decode step on the same state: two
# different bf16 attention paths through 28 layers; hold max |delta logit|
# to 5% of the logits' max magnitude.
BF16_STEP_REL = 0.05


def emit(phase: str, **data) -> None:
    print(json.dumps({"phase": phase, **data}, default=str), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# Card peaks (NVIDIA data sheets, dense): bytes/s and FLOP/s by dtype
# ---------------------------------------------------------------------------
def card_peaks(name: str) -> dict:
    if "PCIe" in name:
        return {"hbm": 2.0e12, "bf16": 756e12, "fp32": 51e12}
    if "NVL" in name:
        return {"hbm": 3.9e12, "bf16": 835e12, "fp32": 60e12}
    return {"hbm": 3.35e12, "bf16": 989e12, "fp32": 67e12}    # H100 SXM


def bound_ms(nbytes: float, flops: float, peaks: dict, dtype_key: str):
    t_bytes = nbytes / peaks["hbm"] * 1e3
    t_ops = flops / peaks[dtype_key] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sync(torch) -> None:
    torch.cuda.synchronize()


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of one call, CUDA events around each call; the L2
    cache is flushed before each call where ``flush`` is given."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        times.append((s, e))
    sync(torch)
    return statistics.median(s.elapsed_time(e) for s, e in times)


def device_only_ms(torch, fn, frag: str, reps: int = 20, flush=None) -> float:
    """The device time, per call of ``fn``, of the kernels whose names hold
    ``frag``: torch.profiler over ``reps`` calls after a warm-up, so the
    host work around the launch (which a CUDA-event window holds) is out.
    A profile that recorded no such kernel (the tracer dropped its device
    records, seen once in many sessions) is taken again, up to 3 times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(torch)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            sync(torch)
        us = sum(v for k, v in _device_by_kernel(prof).items() if frag in k)
        if us > 0:
            return us / reps / 1e3
    fail(f"the profiler saw no kernel named *{frag}* in 3 profiles")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_env(torch) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    emit("env", nvidia_smi=smi_line, device=name, capability=list(cap),
         device_count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    check(tuple(cap) == (9, 0), f"capability {cap} != (9, 0)")
    return {"smi": smi_line, "name": name, "peaks": card_peaks(name)}


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build_library(verbose=True)
    build.library()
    ptxas = [ln.strip() for ln in str(build.BUILD_INFO.get("log", "")).splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, library=lib.name,
         sources=build.BUILD_INFO["sources"], ptxas=ptxas)


def _transfer_case(torch, spec, nb_src, n_tokens, gen):
    """A qwen3-1.7b P->D transfer table for one prompt: src blocks from a
    FLOWKV allocator run, dst blocks scattered (two aligned runs)."""
    from repro_torch.core.transfer import TransferPlanner

    n = spec.blocks_for_tokens(n_tokens)
    src_blocks = list(range(3, 3 + n))
    dst_blocks = list(range(40, 40 + n // 2)) + list(range(120, 120 + n - n // 2))
    plan = TransferPlanner(spec).plan_flowkv(src_blocks, dst_blocks)
    table = plan.to_descriptors()
    dev = DEVICE
    sp = torch.as_tensor(table.page_ids(spec, "src"), dtype=torch.int32).to(dev)
    dp = torch.as_tensor(table.page_ids(spec, "dst"), dtype=torch.int32).to(dev)
    return plan, sp, dp


def phase_kernels(torch, env) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.layout import KVCacheSpec
    from repro_torch.kernels.kv_gather import (append_slot_ids, kv_append_ref,
                                               kv_append_tokens, kv_transfer,
                                               kv_transfer_ref, stage_tokens)

    peaks = env["peaks"]
    cfg = get_config(ARCH)
    L, KV, hd, bs, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.block_size, cfg.num_heads
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    dev = DEVICE
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)     # 256 MB > L2
    rows = {}

    # -- K1: the P->D transfer table of a 1000-token prompt (bf16) -------------
    spec = KVCacheSpec(num_layers=L, num_blocks=256, block_size=bs,
                       num_kv_heads=KV, head_dim=hd, dtype=torch.bfloat16)
    src = torch.randn(spec.shape, generator=gen, device=dev).to(torch.bfloat16)
    dst0 = torch.randn(spec.shape, generator=gen, device=dev).to(torch.bfloat16)
    plan, sp, dp = _transfer_case(torch, spec, 256, 1000, gen)
    n = int(sp.numel())
    dst_k, dst_p = dst0.clone(), dst0.clone()
    kv_transfer(src, dst_k, sp, dp)
    kv_transfer_ref(src, dst_p, sp, dp)
    sync(torch)
    exact = bool(torch.equal(dst_k.view(torch.int16), dst_p.view(torch.int16)))
    k1_err = float((dst_k.float() - dst_p.float()).abs().max())
    untouched = torch.ones(dst0.numel() // spec.payload, dtype=torch.bool, device=dev)
    untouched[dp.long()] = False
    kept = bool(torch.equal(dst_k.view(-1, spec.payload)[untouched].view(torch.int16),
                            dst0.view(-1, spec.payload)[untouched].view(torch.int16)))
    check(exact and kept, f"K1 transfer not bit-exact (exact={exact}, untouched kept={kept}, "
                          f"max |delta| {k1_err})")
    row_bytes = spec.payload * 2
    moved = 2 * n * row_bytes + 2 * n * 4
    sf, df = src.view(-1, spec.payload), dst_k.view(-1, spec.payload)
    spl, dpl = sp.long(), dp.long()
    t_k = time_ms(torch, lambda: kv_transfer(src, dst_k, sp, dp), flush=flush)
    t_p = time_ms(torch, lambda: kv_transfer_ref(src, dst_p, sp, dp), flush=flush)
    t_l = time_ms(torch, lambda: df.index_copy_(0, dpl, sf.index_select(0, spl)), flush=flush)
    b_ms, b_by = bound_ms(moved, 0, peaks, "bf16")
    rows["kv_transfer"] = dict(
        shape=f"P->D 1000 tokens: {n} pages x {row_bytes} B bf16", max_abs_err=k1_err,
        ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
        bytes=moved, gbps=moved / t_k / 1e6)
    emit("kernels", kernel="kv_transfer", case="transfer", pages=n, row_bytes=row_bytes,
         bit_exact=exact, untouched_kept=kept, max_abs_err=k1_err, ms=t_k, plain_ms=t_p,
         library_ms=t_l,
         bound_ms=b_ms, achieved_gbps=moved / t_k / 1e6, calls=plan.num_calls)
    del src, dst0, dst_k, dst_p, sf, df

    # -- K1 via K2: one decode step's append, B=8 with two pad lanes (bf16) ----
    pool = torch.randn(spec.shape, generator=gen, device=dev).to(torch.bfloat16)
    B = 8
    real = [37, 1999, 512, 1023, 64, 1500]
    positions = torch.tensor(real + [real[0]] * 2, dtype=torch.int32, device=dev)
    tables = torch.stack([torch.randperm(256, generator=gen, device=dev)[:64]
                          for _ in range(B)]).to(torch.int32)
    tables[6:] = tables[0]                                      # pad lanes copy lane 0
    k_new = torch.randn((L, B, KV, hd), generator=gen, device=dev).to(torch.bfloat16)
    v_new = torch.randn((L, B, KV, hd), generator=gen, device=dev).to(torch.bfloat16)
    k_new[:, 6:], v_new[:, 6:] = k_new[:, :1], v_new[:, :1]
    pool_k, pool_p = pool.clone(), pool.clone()
    kv_append_tokens(pool_k, tables, positions, k_new, v_new, block_size=bs)
    kv_append_ref(pool_p, tables.cpu(), positions.cpu(), k_new, v_new, bs)
    sync(torch)
    a_exact = bool(torch.equal(pool_k.view(torch.int16), pool_p.view(torch.int16)))
    a_err = float((pool_k.float() - pool_p.float()).abs().max())
    check(a_exact, f"K1 append (K2) not bit-exact against kv_append_ref (max |delta| {a_err})")
    staging = stage_tokens(k_new, v_new).contiguous()
    ids = append_slot_ids(tables, positions, L, bs)
    srcid = torch.arange(staging.shape[0], dtype=torch.int32, device=dev)
    view = pool_k.view(256, L, 2, bs, KV * hd)
    vflat = view.view(-1, KV * hd)
    idl, srl = ids.long(), srcid.long()
    na = int(ids.numel())
    t_ka = time_ms(torch, lambda: kv_transfer(staging, view, srcid, ids), flush=flush)
    t_pa = time_ms(torch, lambda: kv_transfer_ref(staging, view, srcid, ids), flush=flush)
    t_la = time_ms(torch, lambda: vflat.index_copy_(0, idl, staging.index_select(0, srl)),
                   flush=flush)
    t_da = device_only_ms(torch, lambda: kv_transfer(staging, view, srcid, ids),
                          "kv_transfer_kernel", flush=flush)
    a_bytes = 2 * na * KV * hd * 2 + 2 * na * 4
    ba_ms, _ = bound_ms(a_bytes, 0, peaks, "bf16")
    emit("kernels", kernel="kv_transfer", case="decode_append B=8 (2 pad lanes)",
         rows=na, row_bytes=KV * hd * 2, bit_exact=a_exact, max_abs_err=a_err,
         ms=t_ka, device_only_ms=t_da, plain_ms=t_pa,
         library_ms=t_la, bound_ms=ba_ms)
    del pool, pool_k, pool_p, view, vflat

    # -- K3: paged decode attention over one layer of a 28-layer pool ---------
    rows["paged_decode_attention"] = _k3_cases(torch, peaks, gen, flush, L, KV, hd, bs, H)
    rows.update(_k4_cases(torch, peaks, gen, flush))
    rows.update(_k5_cases(torch, peaks, gen, flush, L, bs, KV, hd))
    del flush
    torch.cuda.empty_cache()
    return rows


# K3 cases: (batch, lengths, table width); the last is e2e_bf16's decode step
K3_CASES = [(1, [2000], 64), (8, [2047, 1500, 0, 33, 1024, 1999, 700, 64], 64),
            (4, [200, 640, 1100, 1500], 64)]


def _k3_cases(torch, peaks, gen, flush, L, KV, hd, bs, H) -> dict:
    """K3 against its plain version at B=1, B=8 (a length-0 row, a padded
    table) and the e2e decode step's B=4, in float32 and bfloat16; and each
    row of the B=8 case bit-identical to the same row alone at B=1 with a
    table exactly its pages wide."""
    from repro_torch.core.layout import KVCacheSpec
    from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                     paged_decode_attention_stats_ref)

    nb = 512
    main = None
    layer = L * 3 // 5
    for dtype in (torch.float32, torch.bfloat16):
        pspec = KVCacheSpec(num_layers=L, num_blocks=nb, block_size=bs,
                            num_kv_heads=KV, head_dim=hd, dtype=dtype)
        kpool = torch.randn(pspec.shape, generator=gen, device=DEVICE).to(dtype)
        for B, lens, W in K3_CASES:
            q = torch.randn((B, H, hd), generator=gen, device=DEVICE).to(dtype)
            bt = torch.stack([torch.randperm(nb, generator=gen, device=DEVICE)[:W]
                              for _ in range(B)]).to(torch.int32)
            for i, ln in enumerate(lens):              # zero-pad past each row's pages
                bt[i, -(-ln // bs):] = 0
            lengths = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
            out, m, l = paged_decode_attention(q, kpool, layer, bt, lengths,
                                               block_size=bs, return_stats=True)
            ro, rm, rl = paged_decode_attention_stats_ref(q, kpool[:, layer], bt, lengths, bs)
            sync(torch)
            err = float((out.float() - ro.float()).abs().max())
            err_m = float((m - rm).abs().max())
            err_l = float(((l - rl).abs() / rl.clamp(min=1e-30)).max())
            zero_ok = True
            if 0 in lens:
                z = lens.index(0)
                zero_ok = bool((out[z] == 0).all() and (l[z] == 0).all()
                               and (m[z] == torch.finfo(torch.float32).min).all())
            check(zero_ok, f"K3 length-0 row wrong ({dtype}, B={B})")
            if dtype == torch.float32:
                ok = err <= FP32_TOL and err_m <= FP32_TOL and err_l <= FP32_TOL
                up_err = err
            else:
                ok = err <= BF16_TOL and err_m <= 5e-2
                uo, um, ul = paged_decode_attention_stats_ref(
                    q.float(), kpool[:, layer].float(), bt, lengths, bs)
                up_err = float((out.float() - uo).abs().max())
                up_m = float((m - um).abs().max())
                up_l = float(((l - ul).abs() / ul.clamp(min=1e-30)).max())
                ok = ok and up_err <= BF16_UPCAST_TOL and up_m <= 1e-4 and up_l <= 1e-4
            check(ok, f"K3 disagrees ({dtype}, B={B}): out {err}, m {err_m}, "
                      f"l rel {err_l}, vs upcast {up_err}")
            identical = None
            if B == 8:                                  # a row alone == the row in the batch
                identical = {}
                for r, ln in enumerate(lens):
                    own = bt[r:r + 1, :max(1, -(-ln // bs))].contiguous()
                    one = paged_decode_attention(q[r:r + 1], kpool, layer, own, lengths[r:r + 1],
                                                 block_size=bs, return_stats=True)
                    identical[ln] = all(bool(torch.equal(a[r:r + 1], b_))
                                        for a, b_ in zip((out, m, l), one))
                check(all(identical.values()),
                      f"K3 {dtype}: rows alone differ from the same rows at B=8: {identical}")
            valid = sum(lens)
            esz = pspec.dtype.itemsize
            nbytes = (2 * valid * KV * hd * esz + 2 * q.numel() * esz
                      + 2 * m.numel() * 4 + bt.numel() * 4 + lengths.numel() * 4)
            flops = 4 * valid * H * hd
            key = "fp32" if dtype == torch.float32 else "bf16"
            b3, b3_by = bound_ms(nbytes, flops, peaks, key)
            plane = kpool[:, layer]
            t3 = time_ms(torch, lambda: paged_decode_attention(
                q, kpool, layer, bt, lengths, block_size=bs, return_stats=True), flush=flush)
            t3p = time_ms(torch, lambda: paged_decode_attention_stats_ref(
                q, plane, bt, lengths, bs), flush=flush)
            t3d = device_only_ms(torch, lambda: paged_decode_attention(
                q, kpool, layer, bt, lengths, block_size=bs, return_stats=True),
                "paged_decode", flush=flush)
            emit("kernels", kernel="paged_decode_attention", dtype=str(dtype), batch=B,
                 lengths=lens, table_width=W, max_abs_err=err, m_err=err_m,
                 l_rel_err=err_l, vs_upcast_err=up_err, length0_ok=zero_ok,
                 rows_alone_bit_identical=identical, ms=t3, device_only_ms=t3d, plain_ms=t3p,
                 faster_than_plain=t3 < t3p, bound_ms=b3, bound_by=b3_by,
                 bound_share=b3 / t3, bytes=nbytes)
            if dtype == torch.bfloat16 and B == 4:
                main = dict(shape=f"B=4 bf16 (the e2e decode step), lengths {lens}, W={W}",
                            max_abs_err=err, ms=t3, plain_ms=t3p, library_ms=None,
                            bound_ms=b3, bound_by=b3_by)
        del kpool
    return main


def _sdpa(torch, q, k, v, q_offset):
    """One scaled_dot_product_attention call on the same inputs (the
    yardstick of ``library_ms``; the port never calls it), in its
    (B, H, S, hd) layout, prepared outside the timed call."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    s, t = q.shape[1], k.shape[1]
    mask = None
    if q_offset:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= q_offset + torch.arange(s, device=q.device)[:, None])
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=mask is None, enable_gqa=True)


def _k4_cases(torch, peaks, gen, flush) -> dict:
    """K4 against its plain version: cold S = T = 1500 and suffix S = 400
    over T = 1456 at qwen3-1.7b's heads, and gemma-2b's heads (hd 256,
    KV 1, H 8) cold at 1024, in float32 and bfloat16; in bfloat16 also
    sim_calibrate's shapes: its sweep's longest prompt (cold 4096), a
    prompt below flash_threshold (cold 256) and the parity run's follower
    (suffix 200 over 1256); and the suffix rows of the fp32 kernel
    bit-identical to the same rows of its cold call."""
    from repro_torch.kernels.flash_prefill import flash_prefill_op, flash_prefill_ref
    from repro_torch.kernels.flash_prefill.ops import launch_plan

    both = (torch.float32, torch.bfloat16)
    cases = [(both, "cold", 1500, 0, 16, 8, 128), (both, "suffix", 400, 1056, 16, 8, 128),
             (both, "cold gemma-2b heads", 1024, 0, 8, 1, 256),
             ((torch.bfloat16,), "cold, the sweep's longest", 4096, 0, 16, 8, 128),
             ((torch.bfloat16,), "cold, below flash_threshold", 256, 0, 16, 8, 128),
             ((torch.bfloat16,), "suffix, the parity follower", 200, 1056, 16, 8, 128)]
    mains = {}
    for dtype in both:
        for dtypes, tag, s, off, H, KV, hd in cases:
            if dtype not in dtypes:
                continue
            t = s + off
            mk = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
            q, k, v = mk(1, s, H, hd), mk(1, t, KV, hd), mk(1, t, KV, hd)
            out = flash_prefill_op(q, k, v, q_offset=off)
            same = flash_prefill_ref(q, k, v, q_offset=off)
            sync(torch)
            err = float((out.float() - same.float()).abs().max())
            if dtype == torch.float32:
                up_err, ok = err, err <= K4_FP32_TOL
            else:
                up = flash_prefill_ref(q.float(), k.float(), v.float(), q_offset=off)
                d = (out.float() - up).abs()
                up_err = float(d.max())
                ok = err <= K4_BF16_TOL and bool((d <= up.abs() * 2.0 ** -8 + 1e-5).all())
                del up, d
            check(ok, f"K4 disagrees ({dtype}, {tag}): {err} vs plain, {up_err} vs upcast")
            pairs = s * off + s * (s + 1) // 2
            esz = q.element_size()
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
            key = "fp32" if dtype == torch.float32 else "bf16"
            b4, b4_by = bound_ms(nbytes, 4 * hd * H * pairs, peaks, key)
            t4 = time_ms(torch, lambda: flash_prefill_op(q, k, v, q_offset=off), flush=flush)
            t4p = time_ms(torch, lambda: flash_prefill_ref(q, k, v, q_offset=off),
                          reps=5, flush=flush)
            t4l = time_ms(torch, _sdpa(torch, q, k, v, off), flush=flush)
            plan = None
            if dtype == torch.float32:      # the fp32 kernel's grid for this call
                plan = launch_plan(1, s, t, H, KV, hd, True,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
            emit("kernels", kernel="flash_prefill", case=tag, dtype=str(dtype), S=s, T=t,
                 q_offset=off, heads=[H, KV, hd], max_abs_err=err, vs_upcast_err=up_err,
                 ms=t4, plain_ms=t4p, library_ms=t4l, bound_ms=b4, bound_by=b4_by,
                 flops=4 * hd * H * pairs, bytes=nbytes, tflops=4 * hd * H * pairs / t4 / 1e9,
                 bound_share=b4 / t4, plan=plan)
            if tag == "cold":
                name = "flash_prefill" if dtype == torch.bfloat16 else "flash_prefill_fp32"
                mains[name] = dict(shape=f"cold S=T={s} {key}, H {H} KV {KV} hd {hd}",
                                   max_abs_err=err, ms=t4, plain_ms=t4p, library_ms=t4l,
                                   bound_ms=b4, bound_by=b4_by)
            del q, k, v, out, same
    # row independence: rows 1056.. of the cold call == the suffix call's rows
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        mk = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
        q, k, v = mk(1, 1456, 16, 128), mk(1, 1456, 8, 128), mk(1, 1456, 8, 128)
        cold = flash_prefill_op(q, k, v)
        identical = {}
        for off in (1056, 1000, 1455):
            identical[off] = bool(torch.equal(flash_prefill_op(q[:, off:], k, v, q_offset=off),
                                              cold[:, off:]))
        sync(torch)
        emit("kernels", kernel="flash_prefill", case=f"suffix rows == cold rows ({name})",
             T=1456, offsets_bit_identical=identical)
        check(all(identical.values()),
              f"K4 {name} suffix rows differ from its cold rows: {identical}")
        del q, k, v, cold
    return mains


def _k5_cases(torch, peaks, gen, flush, L, bs, KV, hd) -> dict:
    """K5a: a 33-block prefix gather; K5b: a 47-block prefill scatter, both
    in bf16 and bit-exact against the plain versions at qwen3-1.7b's block
    shape, untouched blocks kept."""
    from repro_torch.kernels.kv_gather import (kv_gather, kv_gather_ref, kv_scatter,
                                               kv_scatter_ref)

    nb, payload = 256, bs * KV * hd
    pool = torch.randn((nb, L, 2, payload), generator=gen, device=DEVICE).to(torch.bfloat16)
    blk_bytes = L * 2 * payload * 2
    rows = {}
    ids = torch.randperm(nb, generator=gen, device=DEVICE)[:33].to(torch.int32)
    got = kv_gather(pool, ids)
    same = kv_gather_ref(pool, ids)
    exact = bool(torch.equal(got.view(torch.int16), same.view(torch.int16)))
    k5a_err = float((got.float() - same.float()).abs().max())
    check(exact, "K5a gather not bit-exact")
    nbytes = 2 * 33 * blk_bytes + ids.numel() * 4
    b5, b5_by = bound_ms(nbytes, 0, peaks, "bf16")
    idl = ids.long()
    t5 = time_ms(torch, lambda: kv_gather(pool, ids), flush=flush)
    t5p = time_ms(torch, lambda: kv_gather_ref(pool, ids), flush=flush)
    t5l = time_ms(torch, lambda: pool.index_select(0, idl), flush=flush)
    emit("kernels", kernel="kv_gather", blocks=33, block_bytes=blk_bytes, bit_exact=exact,
         max_abs_err=k5a_err, ms=t5, plain_ms=t5p, library_ms=t5l, bound_ms=b5, bound_by=b5_by,
         achieved_gbps=nbytes / t5 / 1e6)
    rows["kv_gather"] = dict(shape=f"33 blocks x {blk_bytes} B bf16", max_abs_err=k5a_err,
                             ms=t5, plain_ms=t5p, library_ms=t5l, bound_ms=b5, bound_by=b5_by)
    del got, same
    host_ids = torch.randperm(nb, generator=gen, device=DEVICE)[:47].to(torch.int32).cpu()
    ids = host_ids.to(DEVICE)              # K5b takes the block manager's host ids
    staging = torch.randn((47, L, 2, payload), generator=gen, device=DEVICE).to(torch.bfloat16)
    a, b = pool.clone(), pool.clone()
    kv_scatter(a, host_ids, staging)
    kv_scatter_ref(b, ids, staging)
    sync(torch)
    exact = bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))
    k5b_err = float((a.float() - b.float()).abs().max())
    kept_ids = torch.ones(nb, dtype=torch.bool, device=DEVICE)
    kept_ids[ids.long()] = False
    kept = bool(torch.equal(a[kept_ids].view(torch.int16), pool[kept_ids].view(torch.int16)))
    check(exact and kept, f"K5b scatter not bit-exact (exact={exact}, untouched kept={kept})")
    nbytes = 2 * 47 * blk_bytes + ids.numel() * 4     # the bf16 rows moved
    b6, b6_by = bound_ms(nbytes, 0, peaks, "bf16")
    idl = ids.long()
    t6 = time_ms(torch, lambda: kv_scatter(a, host_ids, staging), flush=flush)
    t6p = time_ms(torch, lambda: kv_scatter_ref(b, ids, staging), flush=flush)
    t6l = time_ms(torch, lambda: b.index_copy_(0, idl, staging), flush=flush)
    t6d = device_only_ms(torch, lambda: kv_scatter(a, host_ids, staging), "kv_transfer_kernel",
                         flush=flush)
    emit("kernels", kernel="kv_scatter", blocks=47, block_bytes=blk_bytes, bit_exact=exact,
         untouched_kept=kept, max_abs_err=k5b_err, ms=t6, device_only_ms=t6d, plain_ms=t6p,
         library_ms=t6l,
         bound_ms=b6, bound_by=b6_by, achieved_gbps=nbytes / t6 / 1e6,
         note="ms includes the upload of the host ids; device_only_ms is K1's kernel alone")
    rows["kv_scatter"] = dict(shape=f"47 blocks x {blk_bytes} B bf16", max_abs_err=k5b_err,
                              ms=t6, plain_ms=t6p, library_ms=t6l, bound_ms=b6,
                              bound_by=b6_by)
    del pool, a, b, staging
    return rows


def _prompts(cfg, lengths, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lengths]


PROMPT_LENS = [200, 640, 1100, 1500]
NEW_TOKENS = 16


def run_cluster(torch, cfg, params, prompts, max_batch_tokens):
    """Serve the prompts through FlowKVClient on 1P+1D; returns (client,
    handles, launch counts of this run)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1, num_blocks=256,
                          max_batch_tokens=max_batch_tokens, device=DEVICE)
    sync(torch)
    reset_launch_counts()
    handles = [client.submit(p, SamplingParams(max_new_tokens=NEW_TOKENS)) for p in prompts]
    client.drain(max_cycles=500)
    sync(torch)
    counts = launch_counts()
    return client, handles, counts


def k1_per_step(cluster, counts, s) -> float:
    """K1 launches per decode step: every transfer record (P->D plan,
    layer-window sub-plans, prefix fetch, retries) counts its dispatches,
    each one K1 launch; the rest are the decode steps' fused appends."""
    moved = sum(t.num_dispatches for t in cluster.transfers)
    return (counts["kv_transfer"] - moved) / s["decode_steps"]


def check_cluster(client, handles, counts, tag):
    s = client.stats()
    xfers = [t for t in client.cluster.transfers if t.kind == "kv"]
    check(s["finished"] == len(handles), f"{tag}: {s['finished']} of {len(handles)} finished")
    check(len(xfers) == len(handles) and all(t.status == "ok" for t in xfers),
          f"{tag}: transfers {[(t.status, t.retries) for t in xfers]}")
    check(all(t.num_dispatches == 1 for t in xfers), f"{tag}: transfer dispatches "
          f"{[t.num_dispatches for t in xfers]} != 1 per plan")
    check(s["transfer_retries"] == 0, f"{tag}: checksum retries {s['transfer_retries']}")
    check(s["decode_dispatches"] == s["decode_steps"] > 0,
          f"{tag}: decode_dispatches {s['decode_dispatches']} != steps {s['decode_steps']}")
    check(counts["kv_transfer"] > 0 and counts["paged_decode_attention"] > 0
          and counts["flash_prefill"] > 0 and counts["kv_scatter"] > 0,
          f"{tag}: kernels not launched on the main path: {counts}")
    check(s["leaked_blocks"] == 0.0, f"{tag}: leaked blocks")
    return s


def phase_e2e(torch, dtype, env):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_model
    from repro_torch.serving.kv_cache import PagedKVCache, spec_for_model

    tag = "e2e_fp32" if dtype == torch.float32 else "e2e_bf16"
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    t0 = time.perf_counter()
    params = get_model(cfg).init(SEED, DEVICE)
    sync(torch)
    init_s = time.perf_counter() - t0
    prompts = _prompts(cfg, PROMPT_LENS, SEED)
    torch.cuda.reset_peak_memory_stats()
    # fp32 keeps the scheduler's default 2048-token budget, so the 1500-token
    # prompt is chunked and the suffix-chunk branch runs; bf16 prefills every
    # prompt whole, so its prefill is the monolithic computation.
    mbt = 2048 if dtype == torch.float32 else 4096
    t0 = time.perf_counter()
    client, handles, counts = run_cluster(torch, cfg, params, prompts, mbt)
    serve_s = time.perf_counter() - t0
    s = check_cluster(client, handles, counts, tag)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outs = [h.request.output_tokens for h in handles]

    mono = []
    for p in prompts:
        g = T.greedy_generate(params, cfg, torch.tensor([p], dtype=torch.int32,
                                                        device=DEVICE), NEW_TOKENS)
        mono.append([int(x) for x in g[0].cpu()])
    for out in outs:
        check(len(out) == NEW_TOKENS, f"{tag}: {len(out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in out), f"{tag}: token out of range")
    agree = [sum(a == b for a, b in zip(o, r)) for o, r in zip(outs, mono)]
    first_ok = all(o[0] == r[0] for o, r in zip(outs, mono))
    # in-cluster wall times: the cluster steps its nodes in turn, so a
    # request's span also holds the other requests' work of those cycles
    timing = [{"prompt_len": r.prompt_len,
               "ttft_wall_s": r.first_token_wall - r.arrival_wall,
               "transfer_wall_s": r.transfer_end_wall - r.transfer_start_wall,
               "decode_steps": r.decode_steps}
              for r in (h.request for h in handles)]
    data = dict(model=cfg.name, dtype=str(dtype), layers=cfg.num_layers,
                d_model=cfg.d_model, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
                max_batch_tokens=mbt, init_s=init_s, serve_s=serve_s,
                peak_mem_gb=peak_gb, launches=counts,
                k1_launches_per_step=None, k3_launches_per_step=counts[
                    "paged_decode_attention"] / s["decode_steps"],
                transfers=s["transfers"], mean_transfer_dispatches=s["mean_transfer_dispatches"],
                mean_transfer_calls=s["mean_transfer_calls"],
                decode_steps=s["decode_steps"], decode_dispatches=s["decode_dispatches"],
                token_agreement=agree, first_tokens_equal=first_ok, timing=timing)
    data["k1_launches_per_step"] = k1_per_step(client.cluster, counts, s)
    if dtype == torch.float32:
        check(outs == mono, f"{tag}: cluster tokens differ from monolithic: {agree}")
    else:
        check(first_ok, f"{tag}: first tokens differ from monolithic prefill")
        # one paged step vs the dense step on the same state
        p = prompts[2]
        tok = torch.tensor([p], dtype=torch.int32, device=DEVICE)
        logits0, pre = T.prefill(params, cfg, tok)
        nxt = torch.argmax(logits0, dim=-1).to(torch.int32)
        kv = PagedKVCache(spec_for_model(cfg, 64), device=DEVICE)
        kv.bm.allocate(0, len(p) + 1)
        kv.write_prefill(0, pre["k"][:, 0], pre["v"][:, 0], len(p))
        bt = torch.as_tensor(kv.export_block_tables([0])).to(DEVICE)
        lens = torch.tensor([len(p)], dtype=torch.int32, device=DEVICE)
        lp, _ = T.decode_step_paged(params, cfg, nxt, kv.pool, bt, lens)
        cache = T.init_cache(cfg, 1, len(p) + 1, device=DEVICE)
        cache["k"][:, :, :len(p)] = pre["k"]
        cache["v"][:, :, :len(p)] = pre["v"]
        cache["length"] = lens.clone()
        ld, _ = T.decode_step(params, cfg, nxt, cache)
        step_err = float((lp - ld).abs().max())
        scale = float(ld.abs().max())
        data.update(step_logit_max_abs_err=step_err, step_logit_scale=scale,
                    step_tolerance=BF16_STEP_REL * scale,
                    step_argmax_equal=bool(torch.equal(lp.argmax(-1), ld.argmax(-1))))
        check(step_err <= BF16_STEP_REL * scale,
              f"{tag}: paged step logits off by {step_err} (scale {scale})")
    if dtype == torch.bfloat16:
        data.update(step_and_transfer_timing(torch, cfg, params, prompts))
        data["cold_prefill_profile"] = profile_cold_prefill(torch, cfg, params, prompts[-1])
        check(data["cold_prefill_profile"]["k4_ms"] > 0,
              f"{tag}: the cold prefill of {len(prompts[-1])} tokens launched no K4")
    emit(tag, **data)
    # handles and client reference each other: collect the cycle so this
    # run's weights and pools are gone before the next phase measures
    del params, client, handles
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _device_by_kernel(prof) -> dict:
    """Device microseconds by kernel name from a torch.profiler run."""
    by_kernel = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False) or evt.key.startswith("ProfilerStep"):
            continue                    # a range on the device timeline, not a kernel
        us = _device_us(evt)
        if us > 0 and evt.device_type is not None and "CUDA" in str(evt.device_type):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    return by_kernel


# kernel-name fragments of each part of a prefill's device time
PREFILL_PARTS = (("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
                 ("k4", ("flash_prefill",)),
                 ("k5a", ("kv_gather_blocks",)),
                 ("k5b", ("kv_transfer_kernel",)))


def _profile_split(torch, fn) -> dict:
    """One synchronized wall and a torch.profiler device-time split of
    ``fn`` (run once before, unprofiled): bf16/fp32 GEMMs, K4, K5a, K5b and
    the rest, with K4's share and the top kernels. The profiler records the
    second of two runs, after a warm-up step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    sync(torch)
    t0 = time.perf_counter()
    fn()
    sync(torch)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            sync(torch)
            prof.step()
    by_kernel = _device_by_kernel(prof)
    total = sum(by_kernel.values())
    parts = {name: 0.0 for name, _ in PREFILL_PARTS}
    parts["rest"] = 0.0
    for key, us in by_kernel.items():
        low = key.lower()
        part = next((name for name, frags in PREFILL_PARTS
                     if any(f in low for f in frags)), "rest")
        parts[part] += us
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:8]
    return dict(wall_ms=wall * 1e3, device_ms=total / 1e3, k4_ms=parts["k4"] / 1e3,
                k4_share=parts["k4"] / total if total else None,
                split_ms={k: v / 1e3 for k, v in parts.items()},
                device_busy_share=(total / 1e6) / wall if wall else None,
                top_kernels_ms=[(k[:80], v / 1e3) for k, v in top])


def profile_cold_prefill(torch, cfg, params, prompt) -> dict:
    """The device-time split of one cold prefill of ``prompt`` with its pool
    write (K5b), outside the cluster loop."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.kv_cache import PagedKVCache, spec_for_model

    kv = PagedKVCache(spec_for_model(cfg, 64), device=DEVICE)
    kv.bm.allocate(0, len(prompt))                 # each call rewrites the same blocks
    tok = torch.tensor([prompt], dtype=torch.int32, device=DEVICE)

    def cold():
        _, c = T.prefill(params, cfg, tok)
        kv.write_prefill(0, c["k"][:, 0], c["v"][:, 0], len(prompt))

    out = dict(prompt_len=len(prompt), **_profile_split(torch, cold))
    del kv
    return out


def step_and_transfer_timing(torch, cfg, params, prompts) -> dict:
    """The decode step at B=len(prompts) on their prefilled K/V, and one
    P->D transfer of the longest prompt, timed outside the cluster loop.

    Step: median wall over 10 synchronized steps (the append rewrites the
    same slots, so the state does not change) and a torch.profiler device
    time split by kernel over 3 steps. Transfer: the K1 launch (CUDA events),
    the device verify's wall and the host blake2b digests' wall, separately.
    """
    from repro_torch.core.transfer import TransferPlanner
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import _next_pow2
    from repro_torch.serving.kv_cache import PagedKVCache, spec_for_model

    kv = PagedKVCache(spec_for_model(cfg, 256), device=DEVICE)
    lens, toks = [], []
    for rid, p in enumerate(prompts):
        logits, pre = T.prefill(params, cfg, torch.tensor([p], dtype=torch.int32, device=DEVICE))
        kv.bm.allocate(rid, len(p) + 1)
        kv.write_prefill(rid, pre["k"][:, 0], pre["v"][:, 0], len(p))
        lens.append(len(p))
        toks.append(int(torch.argmax(logits[0])))
    tables = kv.export_block_tables(list(range(len(prompts))))
    b, w = len(prompts), _next_pow2(tables.shape[1])
    bt = torch.zeros((_next_pow2(b), w), dtype=torch.int32)
    bt[:b, :tables.shape[1]] = torch.from_numpy(tables)
    bt[b:] = bt[0]
    bt = bt.to(DEVICE)
    tok = torch.tensor(toks + toks[:1] * (bt.shape[0] - b), dtype=torch.int32, device=DEVICE)
    ln = torch.tensor(lens + lens[:1] * (bt.shape[0] - b), dtype=torch.int32, device=DEVICE)

    def step():
        return T.decode_step_paged(params, cfg, tok, kv.pool, bt, ln)

    for _ in range(3):
        step()
    sync(torch)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        sync(torch)
        walls.append(time.perf_counter() - t0)
    out = {"step_batch": b, "step_lengths": lens, "step_wall_ms": statistics.median(walls) * 1e3}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        sync(torch)
        wall = time.perf_counter() - t0
    by_kernel = _device_by_kernel(prof)
    total = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:8]
    k3_us = sum(v for k, v in by_kernel.items() if "paged_decode" in k)   # every K3 kernel
    out.update(step_device_ms=total / 3e3, step_profiled_wall_ms=wall / 3 * 1e3,
               k3_ms=k3_us / 3e3, k3_share=k3_us / total if total else None,
               step_device_busy_share=(total / 1e6) / wall if wall else None,
               step_top_kernels_ms=[(k[:80], v / 3e3) for k, v in top])

    # one P->D transfer of the longest prompt: kernel time vs verification
    rid = max(range(len(prompts)), key=lambda i: lens[i])
    dst = PagedKVCache(spec_for_model(cfg, 256), device=DEVICE)
    dst_blocks = dst.bm.allocate(0, lens[rid] + 1)
    plan = TransferPlanner(kv.spec).plan("flowkv", kv.bm.get(rid)[:len(dst_blocks)], dst_blocks)
    out.update(transfer_tokens=lens[rid], **_transfer_split(torch, kv, dst, plan))
    return out


# ---------------------------------------------------------------------------
# e2e_prefix: the prefill data plane (prefix reuse, chunking, layer windows)
# ---------------------------------------------------------------------------
PREFIX_LEN = 1056                      # 33 blocks: a shared system prompt
DONOR_TAIL = 64
FOLLOWER_TAILS = [96, 200, 400]
PREFIX_NEW_TOKENS = 8
LAYER_WINDOW = 7                       # 4 sub-plans per P->D transfer at 28 layers
CHUNK_TOKENS = 384                     # the donor's 1120 tokens take 3 chunks


def _staggered(torch, cfg, params, prompts, **kw):
    """Serve the donor, then the followers once the donor's KV is resident
    on the decode node; returns (cluster, requests, launch counts, span
    recorder, per-request fetch walls)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs.tracing import attach_tracer
    from repro_torch.serving.cluster import PDCluster
    from repro_torch.serving.request import Request, SamplingParams

    cluster = PDCluster(cfg, params, num_prefill=1, num_decode=1, num_blocks=256,
                        max_batch_tokens=4096, device=DEVICE, **kw)
    rec = attach_tracer(cluster)
    fetch_wall = {}
    fetch = cluster._fetch_prefix

    def timed_fetch(engine, req):          # a synchronized wall around the fetch
        sync(torch)
        t0 = time.perf_counter()
        fetch(engine, req)
        sync(torch)
        fetch_wall[req.request_id] = fetch_wall.get(req.request_id, 0.0) + \
            time.perf_counter() - t0

    cluster._fetch_prefix = timed_fetch
    reqs = [Request(prompt_tokens=list(p),
                    sampling=SamplingParams(max_new_tokens=PREFIX_NEW_TOKENS))
            for p in prompts]
    sync(torch)
    reset_launch_counts()
    cluster.submit(reqs[0])
    for _ in range(40):
        cluster.step()
        if reqs[0].transfer_end_wall is not None:
            break
    check(reqs[0].transfer_end_wall is not None, "e2e_prefix: the donor never transferred")
    for r in reqs[1:]:
        cluster.submit(r)
    for _ in range(300):
        cluster.step()
        if len(cluster.finished) == len(reqs):
            break
    sync(torch)
    counts = launch_counts()
    check(len(cluster.finished) == len(reqs),
          f"e2e_prefix: {len(cluster.finished)} of {len(reqs)} finished")
    return cluster, reqs, counts, rec, fetch_wall


def _prefix_run_summary(cluster, reqs, counts, rec, fetch_wall, tag) -> dict:
    s = cluster.stats()
    total = sum(r.prompt_len for r in reqs)
    windows = -(-cluster.cfg.num_layers // LAYER_WINDOW)
    kv = [t for t in cluster.transfers if t.kind == "kv"]
    fetches = [t for t in cluster.transfers if t.kind == "prefix_fetch"]
    check(s["prefill_tokens_computed"] == total - s["prefix_tokens_reused"],
          f"{tag}: prefill_tokens_computed {s['prefill_tokens_computed']} != "
          f"{total} - {s['prefix_tokens_reused']}")
    check(len(kv) == len(reqs) and all(t.status == "ok" and t.num_dispatches == windows
                                       for t in kv),
          f"{tag}: P->D transfers {[(t.status, t.num_dispatches) for t in kv]}, "
          f"want {windows} window sub-plans of one dispatch each")
    check(all(t.num_dispatches == 1 for t in fetches),
          f"{tag}: prefix fetch dispatches {[t.num_dispatches for t in fetches]} != 1")
    check(s["transfer_retries"] == 0, f"{tag}: checksum retries {s['transfer_retries']}")
    check(s["leaked_blocks"] == 0.0, f"{tag}: leaked blocks")
    cluster.assert_no_leaks()
    chunks = {r.request_id: sorted((sp.attrs["offset"], sp.attrs["tokens"])
                                   for sp in rec.spans if sp.name == "prefill_chunk"
                                   and sp.trace_id == r.request_id) for r in reqs}
    timing = [{"prompt_len": r.prompt_len, "cached_prefix": r.num_cached_prefix_tokens,
               "chunks": chunks[r.request_id],
               "ttft_wall_s": r.first_token_wall - r.arrival_wall,
               "prefill_wall_s": r.prefill_end_wall - r.prefill_start_wall,
               "fetch_wall_s": fetch_wall.get(r.request_id, 0.0),
               "transfer_wall_s": r.transfer_end_wall - r.transfer_start_wall}
              for r in reqs]
    return dict(launches=counts, k1_launches_per_step=k1_per_step(cluster, counts, s),
                prefix_hits=s["prefix_hits"], prefix_tokens_reused=s["prefix_tokens_reused"],
                prefix_fetches=s["prefix_fetches"],
                prefill_tokens_computed=s["prefill_tokens_computed"], total_prompt=total,
                transfers=[(t.kind, t.num_dispatches) for t in cluster.transfers],
                decode_steps=s["decode_steps"], timing=timing)


def _profile_prefill(torch, cfg, params, donor, follower) -> dict:
    """Device time by kernel of the donor's cold prefill and of one
    follower's suffix prefill over the cached prefix, each with its pool
    write (and the follower's prefix read), outside the cluster loop."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.kv_cache import PagedKVCache, spec_for_model

    kv = PagedKVCache(spec_for_model(cfg, 128), device=DEVICE)
    kv.bm.allocate(0, len(donor))            # each call rewrites the same blocks
    kv.bm.allocate(1, len(follower))

    def cold():
        _, c = T.prefill(params, cfg, torch.tensor([donor], dtype=torch.int32, device=DEVICE))
        kv.write_prefill(0, c["k"][:, 0], c["v"][:, 0], len(donor))

    def suffix():
        kp, vp = kv.gather_prefix(0, PREFIX_LEN)
        tok = torch.tensor([follower[PREFIX_LEN:]], dtype=torch.int32, device=DEVICE)
        _, c = T.prefill_suffix(params, cfg, tok, kp[:, None], vp[:, None])
        kv.write_prefill(1, c["k"][:, 0], c["v"][:, 0], len(follower) - PREFIX_LEN,
                         start=PREFIX_LEN)

    out = {name: _profile_split(torch, fn)
           for name, fn in (("donor_cold", cold), ("follower_suffix", suffix))}
    del kv
    return out


def phase_e2e_prefix(torch, env) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_model
    from repro_torch.sim.hardware import H100

    tag = "e2e_prefix"
    cfg = dataclasses.replace(get_config(ARCH), dtype=torch.float32)
    params = get_model(cfg).init(SEED, DEVICE)
    rng = np.random.RandomState(SEED + 1)
    prefix = rng.randint(0, cfg.vocab_size, size=PREFIX_LEN).tolist()
    prompts = [prefix + rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in [DONOR_TAIL] + FOLLOWER_TAILS]
    check(min(map(len, prompts)) > cfg.flash_threshold, "every prompt must take K4")
    t0 = time.perf_counter()
    mono = [[int(x) for x in T.greedy_generate(
        params, cfg, torch.tensor([p], dtype=torch.int32, device=DEVICE),
        PREFIX_NEW_TOKENS)[0].cpu()] for p in prompts]
    mono_s = time.perf_counter() - t0

    def outs(reqs):
        return [list(r.output_tokens) for r in reqs]

    # (1) reuse on, layer windows. At these sizes the default H100 profile
    # prices recomputing the prefix below fetching it (held on the CPU by
    # test_torch_control_plane.py), so the router is given a card with little
    # compute, as the reference's test does, to make it fetch.
    hw = dataclasses.replace(H100, peak_flops=1e6)
    run = _staggered(torch, cfg, params, prompts, prefix_reuse=True,
                     layer_window=LAYER_WINDOW, hardware=hw)
    on = _prefix_run_summary(*run, tag + " reuse on")
    on_outs, on_counts = outs(run[1]), run[2]
    check(on["prefix_hits"] >= 1 and on["prefix_fetches"] >= 1,
          f"{tag}: reuse on gave {on['prefix_hits']} hits, {on['prefix_fetches']} fetches")
    cold_k4 = on_counts["flash_prefill"] - on_counts["flash_prefill_suffix"]
    check(cold_k4 > 0 and on_counts["flash_prefill_suffix"] > 0 and
          on_counts["kv_gather"] > 0 and on_counts["kv_scatter"] > 0,
          f"{tag}: K4 cold/suffix, K5a or K5b not launched: {on_counts}")
    del run
    gc.collect()
    # (2) reuse off
    run = _staggered(torch, cfg, params, prompts, prefix_reuse=False,
                     layer_window=LAYER_WINDOW, hardware=hw)
    off = _prefix_run_summary(*run, tag + " reuse off")
    off_outs = outs(run[1])
    check(off["prefix_hits"] == 0 and off["prefill_tokens_computed"] == off["total_prompt"],
          f"{tag}: reuse off still reused: {off['prefix_hits']} hits")
    del run
    gc.collect()
    # (4) chunked, reuse on
    run = _staggered(torch, cfg, params, prompts, prefix_reuse=True,
                     layer_window=LAYER_WINDOW, hardware=hw,
                     prefill_chunk_tokens=CHUNK_TOKENS)
    chunked = _prefix_run_summary(*run, tag + " chunked")
    chunked_outs = outs(run[1])
    check(len(chunked["timing"][0]["chunks"]) >= 3,
          f"{tag}: the donor took {chunked['timing'][0]['chunks']}, want >= 3 chunks")
    del run
    gc.collect()
    agree = {"reuse_on": on_outs == mono, "reuse_off": off_outs == mono,
             "chunked": chunked_outs == mono}
    check(all(agree.values()), f"{tag}: tokens differ from monolithic: {agree}")
    profile_ = _profile_prefill(torch, cfg, params, prompts[0], prompts[-1])
    emit(tag, model=cfg.name, dtype=str(cfg.dtype), layers=cfg.num_layers,
         prefix_len=PREFIX_LEN, prompt_lens=[len(p) for p in prompts],
         new_tokens=PREFIX_NEW_TOKENS, layer_window=LAYER_WINDOW,
         chunk_tokens=CHUNK_TOKENS, router_profile="H100 with peak_flops=1e6",
         monolithic_s=mono_s,
         tokens_identical=agree, reuse_on=on, reuse_off=off, chunked=chunked,
         prefill_profile=profile_)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return on_counts


# ---------------------------------------------------------------------------
# e2e_faults_tier: the fault plane, the serving checkpoint and the host tier
# ---------------------------------------------------------------------------
FT_PROMPT_LENS = [300, 1500]
FT_NEW_TOKENS = 8
FT_BLOCKS = 128                        # pool blocks a node in the fault runs
CKPT_BLOCKS = 64                       # ~470 MB a node of fp32 in pools.npz
KILL_AFTER = 3                         # decode steps of the victim before its node dies
TIER_BLOCKS = 48                       # pool blocks a node in the tier runs
TIER_HOST_BLOCKS = 128                 # host-tier blocks a node (pinned; holds the prefix and the churn)
TIER_CHURN = [1400, 1400]              # unrelated prompts whose pressure demotes the prefix
TIER_FOLLOWER_TAIL = 200
# bytes a lane moves per second and direction, by PCIe generation (encoding
# 8b/10b through gen 2, 128b/130b after)
PCIE_LANE_BPS = {1: 0.25e9, 2: 0.5e9, 3: 0.985e9, 4: 1.969e9, 5: 3.938e9}


def _fault_run(torch, cfg, params, prompts, mono, tag, faults=None):
    """Serve ``prompts`` on 1P+2D under ``faults`` through a FlowKVClient,
    reading every stream round-robin: every request finishes with the
    monolithic tokens, each streamed exactly once, and nothing leaks.
    Returns (handles, summary)."""
    from repro_torch.faults import FaultInjector
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=2, num_blocks=FT_BLOCKS,
                          max_batch_tokens=4096, device=DEVICE, heartbeat_timeout_cycles=2.0,
                          faults=None if faults is None else FaultInjector(faults, seed=SEED))
    sync(torch)
    reset_launch_counts()
    t0 = time.perf_counter()
    handles = [client.submit(list(p), SamplingParams(max_new_tokens=FT_NEW_TOKENS))
               for p in prompts]
    streams = {h.request_id: [] for h in handles}
    gens = {h.request_id: h.tokens(max_cycles=400) for h in handles}
    done = set()
    while len(done) < len(handles):
        for h in handles:
            if h.request_id not in done:
                tok = next(gens[h.request_id], None)
                if tok is None:
                    done.add(h.request_id)
                else:
                    streams[h.request_id].append(int(tok))
    sync(torch)
    wall = time.perf_counter() - t0
    cluster = client.cluster
    outs = [list(map(int, h.request.output_tokens)) for h in handles]
    check(outs == mono, f"{tag}: tokens differ from monolithic")
    check(all(streams[h.request_id] == o for h, o in zip(handles, outs)),
          f"{tag}: a stream saw a token twice or missed one")
    check(cluster.audit_blocks() == 0, f"{tag}: leaked blocks")
    cluster.assert_no_leaks()
    s = cluster.stats()
    summary = {k: s[k] for k in ("fault_kills", "transfer_retries", "degraded_to_recompute",
                                 "recoveries", "decode_steps")}
    summary.update(wall_s=wall, launches=launch_counts(),
                   transfers=[(t.status, t.retries, t.num_dispatches) for t in cluster.transfers],
                   decode_nodes=[h.request.decode_node for h in handles],
                   cycles=[(h.request.prefill_end, h.request.finish_time) for h in handles])
    return handles, summary


def _transfer_split(torch, src_kv, dst_kv, plan) -> dict:
    """One P->D transfer: the K1 launch (CUDA events), the device verify's
    wall, and the host blake2b digests of the same pages (the verify the
    port ran before) in the same run."""
    from repro_torch.core.transfer import TransferEngine, payload_digest, verify_transfer

    engine = TransferEngine(src_kv.spec, dst_kv.spec)
    t_exec = time_ms(torch, lambda: engine.execute(plan, src_kv.pool, dst_kv.pool), reps=10)
    walls, ok = [], True
    for _ in range(5):
        sync(torch)
        t0 = time.perf_counter()
        ok = ok and verify_transfer(plan, src_kv.spec, src_kv.pool, dst_kv.spec, dst_kv.pool)
        sync(torch)
        walls.append(time.perf_counter() - t0)
    check(ok, "the device verify rejected a clean transfer")
    table = plan.to_descriptors()
    t0 = time.perf_counter()
    same = payload_digest(src_kv.pool, src_kv.spec, table.page_ids(src_kv.spec, "src")) == \
        payload_digest(dst_kv.pool, dst_kv.spec, table.page_ids(dst_kv.spec, "dst"))
    blake = time.perf_counter() - t0
    check(same, "the host digests of a clean transfer differ")
    # one flipped bit: the device verify must say no, as the digests do
    pid = int(table.page_ids(dst_kv.spec, "dst")[0])
    bits = dst_kv.pool.view(-1, dst_kv.spec.payload).view(
        torch.int16 if dst_kv.pool.element_size() == 2 else torch.int32)
    bits[pid, 0] ^= 1
    caught = not verify_transfer(plan, src_kv.spec, src_kv.pool, dst_kv.spec, dst_kv.pool)
    bits[pid, 0] ^= 1
    check(caught, "the device verify missed a corrupted element")
    return dict(transfer_bytes=plan.total_bytes, transfer_kernel_ms=t_exec,
                transfer_verify_wall_ms=statistics.median(walls) * 1e3,
                transfer_verify_first_wall_ms=walls[0] * 1e3,
                host_blake2b_wall_ms=blake * 1e3)


def _pcie_link(torch, busy) -> dict:
    """The host link as nvidia-smi reads it while ``busy`` keeps it moving
    (an idle link may report a lower generation)."""
    for _ in range(20):
        busy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
                          "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    sync(torch)
    vals = [v.strip() for v in smi.stdout.strip().splitlines()[0].split(",")] \
        if smi.returncode == 0 and smi.stdout.strip() else []
    try:
        gen, width = int(vals[0]), int(vals[1])
        source = "current under load"
    except (IndexError, ValueError):
        gen, width, source = 5, 16, "not readable; H100 SXM's gen 5 x16 assumed"
    return dict(pcie_gen=gen, pcie_width=width, pcie_read=vals, pcie_source=source,
                link_bps=PCIE_LANE_BPS.get(gen, PCIE_LANE_BPS[5]) * width)


def _host_route_timing(torch, cfg, peaks) -> dict:
    """K1 between a card pool and a pinned host pool on the tier's plan
    shape (the 33 blocks of the shared prefix, fp32): demote and promote
    against the plain version (bit-exact) and their bound over the host
    link, beside the PyTorch calls that make the same move."""
    from repro_torch.core.transfer import TransferPlanner
    from repro_torch.kernels.kv_gather import kv_transfer, kv_transfer_ref
    from repro_torch.serving.kv_cache import spec_for_model

    spec = spec_for_model(cfg, 64)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 7)
    pool = torch.randn(spec.shape, generator=gen, device=DEVICE)
    host = torch.empty(spec.shape, dtype=spec.dtype, pin_memory=True)
    host.copy_(torch.randn(spec.shape, generator=gen, device=DEVICE).cpu())
    n = PREFIX_LEN // spec.block_size
    blocks, hb = list(range(5, 5 + n)), list(range(20, 20 + n))
    planner = TransferPlanner(spec)
    down = planner.plan("flowkv", blocks, hb).to_descriptors()
    up = planner.plan("flowkv", hb, blocks).to_descriptors()

    def pages(table, side):
        return torch.as_tensor(table.page_ids(spec, side), dtype=torch.int32).to(DEVICE)

    dsp, ddp, usp, udp = pages(down, "src"), pages(down, "dst"), pages(up, "src"), pages(up, "dst")
    nbytes = int(dsp.numel()) * spec.payload * 4
    ids = torch.as_tensor(blocks, device=DEVICE)
    out = {"blocks": n, "pages": int(dsp.numel()), "bytes": nbytes}
    # bit-exact against the plain version, both directions
    want_h = host.clone()
    kv_transfer_ref(pool, want_h, dsp, ddp)
    kv_transfer(pool, host, dsp, ddp)
    sync(torch)
    d_err = float((host - want_h).abs().max())
    check(torch.equal(host.view(torch.int32), want_h.view(torch.int32)),
          f"K1 demote to pinned memory not bit-exact (max |delta| {d_err})")
    pool2 = torch.randn(spec.shape, generator=gen, device=DEVICE)
    want_d = pool2.clone()
    kv_transfer_ref(host, want_d, usp, udp)
    kv_transfer(host, pool2, usp, udp)
    sync(torch)
    u_err = float((pool2 - want_d).abs().max())
    check(torch.equal(pool2.view(torch.int32), want_d.view(torch.int32)),
          f"K1 promote from pinned memory not bit-exact (max |delta| {u_err})")
    link = _pcie_link(torch, lambda: kv_transfer(host, pool2, usp, udp))
    b_ms = max(nbytes / link["link_bps"], 2 * nbytes / peaks["hbm"]) * 1e3
    hview = host[20:20 + n]                  # the host blocks are one contiguous run
    for name, k_fn, p_fn, l_fn in (
            ("demote", lambda: kv_transfer(pool, host, dsp, ddp),
             lambda: kv_transfer_ref(pool, host, dsp, ddp),
             lambda: hview.copy_(pool.index_select(0, ids), non_blocking=True)),
            ("promote", lambda: kv_transfer(host, pool2, usp, udp),
             lambda: kv_transfer_ref(host, pool2, usp, udp),
             lambda: pool2.index_copy_(0, ids, hview.to(DEVICE, non_blocking=True)))):
        out[name] = dict(ms=time_ms(torch, k_fn, reps=10), plain_ms=time_ms(torch, p_fn, reps=5),
                         library_ms=time_ms(torch, l_fn, reps=10), bound_ms=b_ms,
                         max_abs_err=d_err if name == "demote" else u_err)
        out[name]["link_share"] = b_ms / out[name]["ms"]
        out[name]["achieved_gbps"] = nbytes / out[name]["ms"] / 1e6
    out.update(link)
    del pool, pool2, host, want_h, want_d
    return out


def _tier_run(torch, cfg, params, prompts, host_blocks, hw, num_decode=2):
    """The donor, then each unrelated prompt, then the follower, one after
    another, each served to the end on 1P+2D (two prompts of the churn at
    once could both be routed to one decode node, which cannot hold them);
    returns (cluster, requests, counts), the cluster traced
    (``cluster.tracer``)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs.tracing import attach_tracer
    from repro_torch.serving.cluster import PDCluster
    from repro_torch.serving.request import Request, SamplingParams

    cluster = PDCluster(cfg, params, num_prefill=1, num_decode=num_decode,
                        num_blocks=TIER_BLOCKS, max_batch_tokens=4096,
                        host_tier_blocks=host_blocks, hardware=hw, device=DEVICE)
    attach_tracer(cluster)
    reqs = [Request(prompt_tokens=list(p), sampling=SamplingParams(max_new_tokens=FT_NEW_TOKENS))
            for p in prompts]
    sync(torch)
    reset_launch_counts()
    for r in reqs:
        cluster.submit(r)
        for _ in range(200):
            if r.request_id in {f.request_id for f in cluster.finished}:
                break
            cluster.step()
        check(r.request_id in {f.request_id for f in cluster.finished},
              "e2e_faults_tier: tier run stalled")
    sync(torch)
    return cluster, reqs, launch_counts()


def phase_e2e_faults_tier(torch, env) -> dict:
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.transfer import TransferPlanner
    from repro_torch.faults import FaultSpec
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_model
    from repro_torch.serving.checkpoint import load_cluster, save_cluster
    from repro_torch.serving.cluster import PDCluster
    from repro_torch.serving.kv_cache import PagedKVCache, spec_for_model
    from repro_torch.serving.request import Request, SamplingParams
    from repro_torch.sim.hardware import H100

    tag = "e2e_faults_tier"
    cfg = dataclasses.replace(get_config(ARCH), dtype=torch.float32)
    params = get_model(cfg).init(SEED, DEVICE)
    rng = np.random.RandomState(SEED + 2)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in FT_PROMPT_LENS]

    def greedy(ps):
        return [[int(x) for x in T.greedy_generate(
            params, cfg, torch.tensor([p], dtype=torch.int32, device=DEVICE),
            FT_NEW_TOKENS)[0].cpu()] for p in ps]

    mono = greedy(prompts)
    data = {"model": cfg.name, "dtype": str(cfg.dtype), "layers": cfg.num_layers,
            "nodes": "1P+2D", "prompt_lens": FT_PROMPT_LENS, "new_tokens": FT_NEW_TOKENS}

    # -- faults: none, a corrupt transfer, every attempt failing, a decode kill
    bh, data["unfaulted"] = _fault_run(torch, cfg, params, prompts, mono, tag + " unfaulted")
    check(data["unfaulted"]["transfer_retries"] == 0, f"{tag}: retries without faults")
    victim = max(bh, key=lambda h: h.request.prompt_len).request
    kill_at = victim.prefill_end + 1 + KILL_AFTER
    check(kill_at < victim.finish_time, f"{tag}: the victim finishes before the kill")
    del bh
    _, data["corrupt"] = _fault_run(torch, cfg, params, prompts, mono, tag + " corrupt",
                                       [FaultSpec("transfer_corrupt", at=0.0, count=1)])
    c = data["corrupt"]
    check(c["transfer_retries"] == 1 and c["degraded_to_recompute"] == 0 and
          c["transfers"][0][:2] == ("ok", 1),
          f"{tag}: the corrupted transfer was not caught and repaired: {c['transfers']}")
    attempts = 4                       # PDCluster's transfer_max_retries (3) + 1
    _, data["fail"] = _fault_run(torch, cfg, params, prompts, mono, tag + " fail",
                                    [FaultSpec("transfer_fail", at=0.0, count=attempts)])
    f = data["fail"]
    check(f["degraded_to_recompute"] == 1 and f["transfer_retries"] == attempts,
          f"{tag}: every attempt failing did not degrade to recompute: {f['transfers']}")
    kh, data["kill"] = _fault_run(
        torch, cfg, params, prompts, mono, tag + " kill",
        [FaultSpec("node_crash", at=kill_at, node_id=victim.decode_node)])
    k = data["kill"]
    check(k["fault_kills"] == 1 and k["recoveries"] >= 1,
          f"{tag}: the decode kill recovered nothing: {k}")
    data["kill"].update(killed_node=victim.decode_node, kill_at=kill_at,
                        replayed_tokens=[h.stats()["replayed_tokens"] for h in kh])
    del kh
    gc.collect()

    # -- the transfer split of one 1500-token P->D transfer (fp32)
    src_kv = PagedKVCache(spec_for_model(cfg, FT_BLOCKS), device=DEVICE)
    dst_kv = PagedKVCache(spec_for_model(cfg, FT_BLOCKS), device=DEVICE)
    src_kv.pool.normal_(generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    n_tok = max(FT_PROMPT_LENS)
    src_blocks = src_kv.bm.allocate(0, n_tok + 1)
    dst_blocks = dst_kv.bm.allocate(0, n_tok + 1)
    plan = TransferPlanner(src_kv.spec).plan("flowkv", src_blocks, dst_blocks)
    data["transfer_split"] = dict(tokens=n_tok, **_transfer_split(torch, src_kv, dst_kv, plan))
    del src_kv, dst_kv
    gc.collect()
    torch.cuda.empty_cache()

    # -- checkpoint mid-stream, restore into a fresh cluster, finish
    def ckpt_cluster():
        return PDCluster(cfg, params, num_prefill=1, num_decode=2, num_blocks=CKPT_BLOCKS,
                         max_batch_tokens=4096, device=DEVICE)

    first = ckpt_cluster()
    reqs = [Request(prompt_tokens=list(p), sampling=SamplingParams(max_new_tokens=FT_NEW_TOKENS))
            for p in prompts]
    for r in reqs:
        first.submit(r)
    for _ in range(40):                  # every request transferred and a few tokens out
        first.step()
        if all(r.transfer_end is not None for r in reqs) and \
                min(len(r.output_tokens) for r in reqs) >= 3:
            break
    emitted = [len(r.output_tokens) for r in reqs]
    check(all(0 < e < FT_NEW_TOKENS for e in emitted),
          f"{tag}: the checkpoint is not mid-stream: {emitted} tokens out")
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        sync(torch)
        t0 = time.perf_counter()
        save_cluster(first, tmp)
        save_s = time.perf_counter() - t0
        npz_bytes = (pathlib.Path(tmp) / "pools.npz").stat().st_size
        del first
        gc.collect()
        torch.cuda.empty_cache()
        second = ckpt_cluster()
        t0 = time.perf_counter()
        load_cluster(second, tmp)
        sync(torch)
        load_s = time.perf_counter() - t0
    for _ in range(100):
        if len(second.finished) >= len(prompts):
            break
        second.step()
    got = {tuple(r.prompt_tokens): list(map(int, r.output_tokens)) for r in second.finished}
    check(got == {tuple(p): m for p, m in zip(prompts, mono)},
          f"{tag}: the restored cluster's tokens differ from monolithic")
    check(second.audit_blocks() == 0, f"{tag}: leaked blocks after the restore")
    data["checkpoint"] = dict(emitted_at_save=emitted, save_s=save_s, load_s=load_s,
                              npz_bytes=npz_bytes, blocks_per_node=CKPT_BLOCKS)
    del second
    gc.collect()
    torch.cuda.empty_cache()

    # -- the host tier: a shared prefix demoted by unrelated pressure, promoted
    prefix = rng.randint(0, cfg.vocab_size, size=PREFIX_LEN).tolist()
    tier_prompts = ([prefix + rng.randint(0, cfg.vocab_size, size=DONOR_TAIL).tolist()]
                    + [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in TIER_CHURN]
                    + [prefix + rng.randint(0, cfg.vocab_size,
                                            size=TIER_FOLLOWER_TAIL).tolist()])
    hw = dataclasses.replace(H100, peak_flops=1e6)     # fetch, not recompute (e2e_prefix)
    tiered, treqs, tcounts = _tier_run(torch, cfg, params, tier_prompts, TIER_HOST_BLOCKS, hw)
    s = tiered.stats()
    follower = treqs[-1]
    total = sum(r.prompt_len for r in treqs)
    tms = {nid: tm.stats() for nid, tm in tiered.tiers.items()}
    promotes = sum(t["promote_dispatches"] for t in tms.values())
    demotes = sum(t["demote_dispatches"] for t in tms.values())
    check(s["tier_demoted_blocks"] >= PREFIX_LEN // cfg.block_size,
          f"{tag}: the pressure demoted {s['tier_demoted_blocks']} blocks")
    check(s["tier_promoted_blocks"] >= PREFIX_LEN // cfg.block_size and promotes == 1,
          f"{tag}: the follower promoted {s['tier_promoted_blocks']} blocks "
          f"in {promotes} dispatches")
    check(follower.num_cached_prefix_tokens >= PREFIX_LEN,
          f"{tag}: the follower reused {follower.num_cached_prefix_tokens} tokens")
    check(tcounts["kv_transfer_host"] == demotes + promotes > 0,
          f"{tag}: {tcounts['kv_transfer_host']} host launches for {demotes} demote and "
          f"{promotes} promote dispatches")
    check(s["prefill_tokens_computed"] == total - s["prefix_tokens_reused"],
          f"{tag}: prefill_tokens_computed {s['prefill_tokens_computed']} != "
          f"{total} - {s['prefix_tokens_reused']}")
    check(tiered.audit_blocks() == 0, f"{tag}: leaked blocks with the tier")   # + tier invariants
    tiered.assert_no_leaks()
    t_outs = [list(map(int, r.output_tokens)) for r in treqs]
    del tiered
    gc.collect()
    plain, preqs, _ = _tier_run(torch, cfg, params, tier_prompts, 0, hw)
    p_outs = [list(map(int, r.output_tokens)) for r in preqs]
    check(plain.audit_blocks() == 0, f"{tag}: leaked blocks without the tier")
    ps = plain.stats()
    del plain
    gc.collect()
    t_mono = greedy(tier_prompts)
    check(t_outs == p_outs == t_mono,
          f"{tag}: tier tokens differ (vs no tier {t_outs == p_outs}, vs monolithic "
          f"{t_outs == t_mono})")
    data["tier"] = dict(
        prompt_lens=[len(p) for p in tier_prompts], pool_blocks=TIER_BLOCKS,
        host_blocks=TIER_HOST_BLOCKS, tiers=tms, launches=tcounts,
        follower_cached=follower.num_cached_prefix_tokens,
        prefill_tokens_computed=s["prefill_tokens_computed"],
        prefix_tokens_reused=s["prefix_tokens_reused"], total_prompt=total,
        follower_ttft_wall_s=follower.first_token_wall - follower.arrival_wall,
        without_tier=dict(prefix_tokens_reused=ps["prefix_tokens_reused"],
                          prefill_tokens_computed=ps["prefill_tokens_computed"],
                          cached_evicted=ps["cached_evicted"]),
        tokens_identical=True)
    torch.cuda.empty_cache()
    data["host_route"] = _host_route_timing(torch, cfg, env["peaks"])
    data["card"] = env["smi"]
    emit(tag, **data)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return tcounts, data["host_route"]


# ---------------------------------------------------------------------------
# sim_calibrate: the H100 profile fitted from the port's prefill; sim = real
# ---------------------------------------------------------------------------
SIM_GAP_S = 1e9        # sim seconds between arrivals: at 1e6 FLOP/s one prompt prices ~1e7 s


def _tier_spans(rec) -> list:
    return [(s.name, s.node_id, s.attrs["num_blocks"]) for s in rec.spans
            if s.name in ("tier_demote", "tier_promote")]


def sim_tier_prompts(cfg) -> list:
    """The parity run's donor (prefix + 64), one churn prompt and follower
    (prefix + 200), from a seed."""
    import numpy as np

    rng = np.random.RandomState(SEED + 3)
    prefix = rng.randint(0, cfg.vocab_size, size=PREFIX_LEN).tolist()
    return [prefix + rng.randint(0, cfg.vocab_size, size=DONOR_TAIL).tolist(),
            rng.randint(0, cfg.vocab_size, size=TIER_CHURN[0]).tolist(),
            prefix + rng.randint(0, cfg.vocab_size, size=TIER_FOLLOWER_TAIL).tolist()]


def _sim_tier_run(cfg, prompts, hw) -> tuple:
    """ClusterSim with the tier run's pool and tier shapes on 1P+1D, the
    prompts arriving one after another; returns (requests, stats, spans)."""
    from repro_torch.obs.tracing import attach_tracer
    from repro_torch.serving.request import Request, SamplingParams
    from repro_torch.sim.cluster_sim import ClusterSim

    sim = ClusterSim(cfg, "flowkv", num_prefill=1, num_decode=1, hw_prefill=hw,
                     hw_decode=hw, blocks_per_node=TIER_BLOCKS,
                     host_tier_blocks=TIER_HOST_BLOCKS)
    rec = attach_tracer(sim)
    reqs = [Request(prompt_tokens=list(p), sampling=SamplingParams(max_new_tokens=FT_NEW_TOKENS),
                    arrival_time=i * SIM_GAP_S) for i, p in enumerate(prompts)]
    stats = sim.run(list(reqs), t_max=SIM_GAP_S * (len(reqs) + 1))
    check(stats["finished"] == len(reqs) and sim.audit_blocks() == 0,
          f"sim_calibrate: the sim finished {stats['finished']} of {len(reqs)} or leaked")
    return reqs, stats, _tier_spans(rec)


def _fit_scored(cal, samples, name) -> dict:
    """``fit_hardware`` on the even samples from the ``H100`` profile,
    scored on the odd ones as ``obs/calibrate.check`` scores a sweep. The
    fit is physical when its slope is positive and its effective FLOP/s at
    most the profile's peak (``fit_compute`` reads a slope <= 0 as 1e18
    FLOP/s, so the second test holds both)."""
    from repro_torch.sim.hardware import H100

    hw = cal.fit_hardware(samples[::2], base=H100, name=name)
    errors = [abs(hw.prefill_time(f) - t) / t for f, t in samples[1::2]]
    eff = hw.peak_flops * hw.mfu_prefill
    return dict(profile=hw, effective_tflops=eff / 1e12, mfu_prefill=hw.mfu_prefill,
                step_overhead_ms=hw.step_overhead_s * 1e3, held_out_rel_errors=errors,
                median_rel_error=statistics.median(errors),
                status="fitted" if 0 < eff <= hw.peak_flops else "degenerate")


def prefill_fn(torch, params, cfg, n: int):
    """One prefill of an ``n``-token prompt, as a call for the timers."""
    from repro_torch.models import transformer as T

    tokens = torch.zeros((1, n), dtype=torch.int32, device=DEVICE)

    def fn():
        with torch.inference_mode():
            T.prefill(params, cfg, tokens)
    return fn


def calibrate_on_card(torch, cfg, params) -> dict:
    """``obs/calibrate.check`` on the card (the wall of the port's prefill
    at GPU_PROMPT_LENS, fitted from ``H100``), then one profiled prefill a
    length for its device time by part, fitted the same way. Returns the
    check's result, the K4 launches of its sweep, the splits and both fits
    (``_fit_scored``)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import calibrate as cal

    sync(torch)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = cal.check(device=DEVICE, arch=cfg.name)
    sync(torch)
    sweep_s = time.perf_counter() - t0
    k4 = launch_counts()["flash_prefill"]
    gc.collect()
    torch.cuda.empty_cache()
    split = [_profile_split(torch, prefill_fn(torch, params, cfg, n))
             for n in cal.GPU_PROMPT_LENS]
    wall_fit = _fit_scored(cal, [tuple(x) for x in res["samples"]], "H100-80G-wall-fit")
    device_fit = _fit_scored(cal, [(f, p["device_ms"] / 1e3)
                                   for (f, _), p in zip(res["samples"], split)],
                             "H100-80G-device-fit")
    return dict(res=res, sweep_s=sweep_s, k4_launches=k4, split=split,
                wall_fit=wall_fit, device_fit=device_fit)


def phase_sim_calibrate(torch, env) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.obs import calibrate as cal
    from repro_torch.sim.hardware import H100

    tag = "sim_calibrate"
    data = {"card": env["smi"]}
    t_phase = time.perf_counter()

    # (a) the port's prefill, full width and depth at the config's own bf16,
    # swept on both sides of flash_threshold; fit on the even points. The
    # gate scores the wall fit's prices; where the host sets the wall its
    # line is nearly flat and may be degenerate, so the device-time fit
    # must be physical.
    cfg = get_config(ARCH)
    check(cfg.dtype == torch.bfloat16, f"{tag}: {ARCH} is not bf16")
    params = get_model(cfg).init(SEED, DEVICE)
    c = calibrate_on_card(torch, cfg, params)
    res, split, lens = c["res"], c["split"], cal.GPU_PROMPT_LENS
    above = sum(1 for n in lens if n > cfg.flash_threshold)
    check(res["config"] == cfg.name and res["base"] == H100.name and
          res["device"].startswith("cuda"),
          f"{tag}: the sweep ran {res['config']} on {res['device']} from {res['base']}")
    check(c["k4_launches"] >= cfg.num_layers * cal.REPEATS * above,
          f"{tag}: {c['k4_launches']} K4 launches for {above} lengths above "
          f"{cfg.flash_threshold} x {cal.REPEATS} timed calls x {cfg.num_layers} layers")
    check(all(np.isfinite(t) and t > 0 for _, t in res["samples"]), f"{tag}: bad walls")
    fits = {k: {n: v for n, v in c[k].items() if n != "profile"}
            for k in ("wall_fit", "device_fit")}
    dev_hw = c["device_fit"]["profile"]
    data["calibration"] = dict(
        model=cfg.name, dtype=str(cfg.dtype), layers=cfg.num_layers, d_model=cfg.d_model,
        repeats=cal.REPEATS, sweep_s=c["sweep_s"], k4_launches=c["k4_launches"],
        bound=res["bound"], **fits,
        sweep=[{"prompt_len": n, "flops": f, "wall_ms": t * 1e3,
                "stock_h100_ms": H100.prefill_time(f) * 1e3,
                "measured_over_stock": t / H100.prefill_time(f),
                "held_out": i % 2 == 1, "device_ms": p["device_ms"],
                "device_fit_ms": dev_hw.prefill_time(f) * 1e3,
                "device_busy_share": p["device_busy_share"], "k4_ms": p["k4_ms"],
                "split_ms": p["split_ms"]}
               for i, (n, (f, t), p) in enumerate(zip(lens, res["samples"], split))])
    check(res["ok"], f"{tag}: median held-out error {res['median_rel_error']:.3f} > "
          f"{res['bound']}")
    check(fits["device_fit"]["status"] == "fitted",
          f"{tag}: the device-time fit is not physical: {fits['device_fit']}")

    # (b) the tier run, real on the card and simulated, 1P+1D: the same
    # decision for the follower and the same demote/promote span stream
    prompts = sim_tier_prompts(cfg)
    weak = dataclasses.replace(H100, peak_flops=1e6)     # fetch, not recompute (e2e_prefix)
    t0 = time.perf_counter()
    cluster, reqs, pcounts = _tier_run(torch, cfg, params, prompts, TIER_HOST_BLOCKS, weak,
                                       num_decode=1)
    real_s = time.perf_counter() - t0
    real_spans = _tier_spans(cluster.tracer)
    s = cluster.stats()
    check(cluster.audit_blocks() == 0, f"{tag}: leaked blocks on the card")
    cluster.assert_no_leaks()
    del cluster, params
    gc.collect()
    torch.cuda.empty_cache()
    sreqs, sstats, sim_spans = _sim_tier_run(cfg, prompts, weak)
    real_hit, sim_hit = reqs[-1].num_cached_prefix_tokens, sreqs[-1].num_cached_prefix_tokens
    data["parity"] = dict(
        nodes="1P+1D", prompt_lens=[len(p) for p in prompts], pool_blocks=TIER_BLOCKS,
        host_blocks=TIER_HOST_BLOCKS, router_profile="H100 with peak_flops=1e6",
        real_s=real_s, launches=pcounts,
        follower_cached=[real_hit, sim_hit],
        prefix_fetches=[s["prefix_fetches"], sstats["prefix_fetches"]],
        tier_spans_equal=real_spans == sim_spans, tier_spans=real_spans,
        tokens=[len(r.output_tokens) for r in reqs])
    check(real_hit == sim_hit > 0, f"{tag}: follower reuse real {real_hit} != sim {sim_hit}")
    check(s["prefix_fetches"] == sstats["prefix_fetches"] >= 1,
          f"{tag}: prefix fetches real {s['prefix_fetches']} != sim {sstats['prefix_fetches']}")
    check(real_spans == sim_spans and {n for n, _, _ in real_spans} ==
          {"tier_demote", "tier_promote"},
          f"{tag}: tier span streams differ:\n real={real_spans}\n  sim={sim_spans}")
    check(all(pcounts[k] > 0 for k in ("kv_transfer", "kv_transfer_host",
                                       "paged_decode_attention", "flash_prefill",
                                       "flash_prefill_suffix", "kv_gather", "kv_scatter")),
          f"{tag}: a kernel was not launched in the parity run: {pcounts}")
    data["seconds"] = time.perf_counter() - t_phase
    emit(tag, **data)


# ---------------------------------------------------------------------------
def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no GPU, no result",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    env = phase_env(torch)
    phase_build()
    rows = phase_kernels(torch, env)
    phase_e2e(torch, torch.float32, env)
    decode_counts = phase_e2e(torch, torch.bfloat16, env)
    prefill_counts = phase_e2e_prefix(torch, env)
    tier_counts, host_route = phase_e2e_faults_tier(torch, env)
    phase_sim_calibrate(torch, env)
    promote = host_route["promote"]
    rows["kv_transfer_host"] = dict(
        promote, bound_by="bytes",
        shape=f"promote {host_route['blocks']} blocks ({host_route['pages']} pages, "
              f"{host_route['bytes']} B fp32) pinned host -> card over PCIe gen "
              f"{host_route['pcie_gen']} x{host_route['pcie_width']}")
    # (source, replaced Pallas call, the path whose launch counts are reported)
    replaces = {
        "kv_transfer": ("src/repro_torch/csrc/kv_transfer.cu",
                        "src/repro/kernels/kv_gather/kv_transfer.py:57", decode_counts),
        "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/paged_attention.py:145",
                                   decode_counts),
        "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                          "src/repro/kernels/flash_prefill/flash_prefill.py:113",
                          decode_counts),
        "flash_prefill_fp32": ("src/repro_torch/csrc/flash_prefill.cu",
                               "src/repro/kernels/flash_prefill/flash_prefill.py:113",
                               prefill_counts),
        "kv_gather": ("src/repro_torch/csrc/kv_gather.cu",
                      "src/repro/kernels/kv_gather/kv_gather.py:42", prefill_counts),
        "kv_scatter": ("src/repro_torch/csrc/kv_transfer.cu",
                       "src/repro/kernels/kv_gather/kv_scatter.py:36", prefill_counts),
        "kv_transfer_host": ("src/repro_torch/csrc/kv_transfer.cu",
                             "src/repro/kernels/kv_gather/kv_transfer.py:57", tier_counts),
    }
    kernels = []
    for name, (source, rep, counts) in replaces.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": counts[name.replace("_fp32", "")], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]})
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(env["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
