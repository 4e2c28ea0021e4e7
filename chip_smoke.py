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
                 table and on a B=8 decode append (bit-exact), K3 at B=1
                 and B=8 with lengths up to ~2k, a padded table and a
                 length-0 row, in float32 and bfloat16 (stated tolerances);
                 kernel, plain, bound and library times.
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
                 wall times. This run is the main path whose kernel launch
                 counts go into the ``kernels`` line.

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
    from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                     paged_decode_attention_stats_ref)

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
    a_bytes = 2 * na * KV * hd * 2 + 2 * na * 4
    ba_ms, _ = bound_ms(a_bytes, 0, peaks, "bf16")
    emit("kernels", kernel="kv_transfer", case="decode_append B=8 (2 pad lanes)",
         rows=na, row_bytes=KV * hd * 2, bit_exact=a_exact, max_abs_err=a_err,
         ms=t_ka, plain_ms=t_pa,
         library_ms=t_la, bound_ms=ba_ms)
    del pool, pool_k, pool_p, view, vflat

    # -- K3: paged decode attention over one layer of a 28-layer pool ---------
    nb = 512
    cases = [(1, [2000], 64), (8, [2047, 1500, 0, 33, 1024, 1999, 700, 64], 64)]
    k3_main = None
    for dtype in (torch.float32, torch.bfloat16):
        pspec = KVCacheSpec(num_layers=L, num_blocks=nb, block_size=bs,
                            num_kv_heads=KV, head_dim=hd, dtype=dtype)
        kpool = torch.randn(pspec.shape, generator=gen, device=dev).to(dtype)
        for B, lens, W in cases:
            layer = L * 3 // 5
            q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
            bt = torch.stack([torch.randperm(nb, generator=gen, device=dev)[:W]
                              for _ in range(B)]).to(torch.int32)
            for i, ln in enumerate(lens):              # zero-pad past each row's pages
                bt[i, -(-ln // bs):] = 0
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
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
            emit("kernels", kernel="paged_decode_attention", dtype=str(dtype), batch=B,
                 lengths=lens, table_width=W, max_abs_err=err, m_err=err_m,
                 l_rel_err=err_l, vs_upcast_err=up_err, length0_ok=zero_ok,
                 ms=t3, plain_ms=t3p, bound_ms=b3, bound_by=b3_by, bytes=nbytes)
            if dtype == torch.bfloat16 and B == 8:
                k3_main = dict(shape=f"B=8 bf16, lengths {lens}, W={W}", max_abs_err=err,
                               ms=t3, plain_ms=t3p, library_ms=None, bound_ms=b3,
                               bound_by=b3_by)
        del kpool
    rows["paged_decode_attention"] = k3_main
    del flush
    torch.cuda.empty_cache()
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
    check(counts["kv_transfer"] > 0 and counts["paged_decode_attention"] > 0,
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
    data["k1_launches_per_step"] = (counts["kv_transfer"] - s["transfers"]) / s["decode_steps"]
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


def step_and_transfer_timing(torch, cfg, params, prompts) -> dict:
    """The decode step at B=len(prompts) on their prefilled K/V, and one
    P->D transfer of the longest prompt, timed outside the cluster loop.

    Step: median wall over 10 synchronized steps (the append rewrites the
    same slots, so the state does not change) and a torch.profiler device
    time split by kernel over 3 steps. Transfer: the K1 launch (CUDA events)
    and the checksum verification (wall) separately.
    """
    from repro_torch.core.transfer import TransferEngine, verify_transfer
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
    by_kernel = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type is not None and "CUDA" in str(evt.device_type):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    total = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:8]
    out.update(step_device_ms=total / 3e3, step_profiled_wall_ms=wall / 3 * 1e3,
               step_device_busy_share=(total / 1e6) / wall if wall else None,
               step_top_kernels_ms=[(k[:80], v / 3e3) for k, v in top])

    # one P->D transfer of the longest prompt: kernel time vs verification
    rid = max(range(len(prompts)), key=lambda i: lens[i])
    dst = PagedKVCache(spec_for_model(cfg, 256), device=DEVICE)
    dst_blocks = dst.bm.allocate(0, lens[rid] + 1)
    engine = TransferEngine(kv.spec, dst.spec)
    plan = engine.planner.plan("flowkv", kv.bm.get(rid)[:len(dst_blocks)], dst_blocks)
    t_exec = time_ms(torch, lambda: engine.execute(plan, kv.pool, dst.pool), reps=10)
    t0 = time.perf_counter()
    ok = verify_transfer(plan, kv.spec, kv.pool, dst.spec, dst.pool)
    t_verify = time.perf_counter() - t0
    check(ok, "transfer verification failed")
    out.update(transfer_tokens=lens[rid], transfer_bytes=plan.total_bytes,
               transfer_kernel_ms=t_exec, transfer_verify_wall_ms=t_verify * 1e3)
    return out


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
    main_counts = phase_e2e(torch, torch.bfloat16, env)
    replaces = {
        "kv_transfer": ("src/repro_torch/csrc/kv_transfer.cu",
                        "src/repro/kernels/kv_gather/kv_transfer.py:57"),
        "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/paged_attention.py:145"),
    }
    kernels = []
    for name, (source, rep) in replaces.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": main_counts[name], "max_abs_err": row["max_abs_err"],
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
