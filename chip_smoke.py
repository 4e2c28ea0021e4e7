#!/usr/bin/env python3
"""Drive the PyTorch port's FlowKV P->D serving path, and its training
path, on one NVIDIA H100.

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
                 and at gemma-2b's head shape (hd 256) and stablelm-12b's
                 (32/8, hd 160: cold 1500, suffix 400 at q_offset 1056,
                 suffix rows bit-identical), in both dtypes (bf16 on the
                 tensor cores; fp32 with its launch plan and its share of
                 the FMA bound), sim_calibrate's bf16 shapes (cold 4096
                 and 256, suffix 200 at q_offset 1056), plus its suffix rows bit-identical to its
                 cold rows in fp32 and in bf16; K5a (33-block gather, its
                 own block copy) and K5b (47-block scatter), bit-exact, K5b
                 also timed device-only; kernel, plain, bound and library
                 times. At e2e_moe_tp's shapes (granite-moe-1b-a400m: L=24,
                 KV=8, hd=64): K1 over the fine (-1, hd) rows of a
                 1500-token bf16 prompt moved TP 2 -> 4 (four shard pairs,
                 bit-exact; the small-row design beside index_copy_ on the
                 same rows and beside one block a row, the design it
                 replaced, with ops.ROWS_BELOW printed), K1 over the
                 decode appends' short tables (48-192 rows of 256 B-1 KiB,
                 both designs bit-exact and timed device-only beside the
                 one ops.rows_from picks), K3 at the
                 heads one shard sees at TP 1 / 2 / 4 (B=4) in both dtypes,
                 K4 cold at granite's heads (S = T = 1500) in both dtypes and
                 in bf16 at llama4-scout's (40/8, hd 128, S = 1500) and
                 llava-next's heads (56/8, hd 128, 2880 patches + 128 text
                 tokens), and K4's suffix rows bit-identical to its cold
                 rows at hd 64.
4. ``e2e_fp32`` — FlowKVClient on full-width, full-depth qwen3-1.7b in
                 float32 (1 prefill + 1 decode node, 256 blocks, 4 prompts
                 of 200-1500 tokens, 16 new tokens each): tokens identical
                 to the port's monolithic greedy_generate, one transfer
                 dispatch per plan, decode_dispatches == decode_steps,
                 checksums pass, K3 run layers times a step and one K1
                 append a step, counted from the profiler's device records
                 (``device_launches``: a graph replay calls no wrapper).
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
                 calls that make the same move, with the design K1 takes
                 each way; its host-route launch count goes into the
                 ``kernels`` line as ``kv_transfer_host``.
8. ``e2e_fleet`` — the Load-Aware Scheduler through FlowKVClient on
                 full-width, full-depth qwen3-1.7b in float32, every pool
                 sized to hold the whole burst (a handoff into a full pool
                 raises in both packages). Imbalance: 1P+3D with
                 ``role_flip``, the nodes declared H100 / H20 / H100 / A100,
                 16 prompts of 1100-2000 tokens (8 at cycle 0, one a cycle
                 after), 8 new tokens each: a decode node flips to prefill,
                 the first the idle decode node ``_capabilities()`` rates
                 most compute-rich; a flipped node runs prefills launching
                 K4 and K5b; every remote handoff launches 1 K1; within 40
                 idle cycles every node is back in its home role. Then every
                 node flipped to prefill by the client: 2 prompts hand off
                 on their own node with no K1. Overload: 1P+1D, an
                 AdmissionPolicy (queue depth 2, 3 defer cycles, retry-after
                 floor 2 s) under 12 such prompts: some rejected (REJECTED,
                 retry_after >= 2 s, a reason, an empty stream, cancel
                 False), none of the rest, stats counting them; after each
                 back-off the rejected prompts are resubmitted until served;
                 a 200-cycle defer policy under 3 prompts defers one and
                 rejects none; each admitted request's predicted TTFT (the
                 data-sheet H100 profile) printed beside its TTFT wall.
                 Preemption: 1P+1D on the smallest pool that admits two
                 1000-token prompts (64 blocks), 64 new tokens each: a
                 request SWAPPED, its K/V gathered by K5a and copied to the
                 host, restored by K5b, no retry; then a third request
                 cancelled while SWAPPED drops its spill. Every token equals
                 monolithic greedy_generate, no block leaks, no spill left.
                 Each run prints its serve wall and cycles, TTFT and decode
                 step walls, handoffs, the controller's events, launches and
                 the device's busy share.
9. ``e2e_moe_tp`` — granite-moe-1b-a400m (32 experts, top-8, dense
                 dispatch) at full width and depth, 1 prefill + 1 decode
                 node of 192 blocks, prompts of 200-1500 tokens, 8 new
                 tokens each, random weights from seed 0 with the
                 attention's wq / wk / wv tempered (``MOE_ATTN_SCALE``;
                 ``tools/moe_conditioning_probe.py`` shows why). float32
                 at TP 1, 2 -> 2 and 2 -> 4: tokens identical to
                 monolithic greedy_generate, whose streams hold at least
                 4 distinct tokens of 8; 1 / 2 / 4 K1
                 launches a transfer (one per shard pair), every device
                 verify passing, no leak, K3 run layers x shards times a
                 step (device records), K1 / K4 / K5b launched. On one prefilled state,
                 the first decode step's logits: paged at TP 1 against
                 dense decode_step, and paged at TP 2 and 4 against TP 1
                 (fail above 1e-3); the sharded prefill of 1100 tokens at
                 TP 2 and 4 against TP 1 (fail above 2e-2); and each limit
                 must be exceeded by a planted fault (shard 1's K3 or K4
                 output rounded to bf16 at TP 2). bfloat16 at TP 1 and 2 -> 4:
                 first tokens equal to monolithic prefill; TTFT and
                 transfer walls; the decode step's wall and device time
                 with K3's and the MoE FFNs' shares against the expert
                 weights' read floor; one cold 1500-token prefill's device
                 time split; the bf16 2 -> 4 run again four times in turns
                 (K1 forced to one block a row, as shipped, as shipped,
                 forced) for its transfer walls. The fp32 2 -> 4 run's
                 fine-row K1 launch count goes into the ``kernels`` line as
                 ``kv_transfer_fine``.
10. ``sim_calibrate`` — the simulator's H100 profile fitted from the port's
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
11. ``e2e_state`` — the state families at full width and depth, one model
                 on the card at a time: mamba2-370m (prompts of 200-1500
                 tokens, 16 new) and recurrentgemma-2b (640, 1500 and 3000
                 tokens, the last across the 2048-slot ring's wrap; 8 new)
                 served 1P+1D through the state path in bfloat16 and
                 float32, tokens identical to the port's monolithic
                 generation, every transfer one ``state`` job of 1
                 dispatch (5 / 11 calls, its bytes printed), no state or
                 block left; in float32 each decode step's logits against
                 the prefill of the prompt plus the tokens so far (1100 /
                 3000 tokens) and mamba2's prefill at ssm_chunk 256 against
                 100, each within STATE_LIMIT while a planted fault reads
                 above it; in bfloat16 the TTFT and handoff walls, one
                 decode step's wall and device time, one cold prefill's
                 device split with the SSD / LRU scan's own device time.
                 seamless-m4t-large-v2 at the model level: 600, 1500 and
                 4096 frames, a 32-token decoder prompt, 8 greedy steps
                 from a padded cache, K4 launched non-causally 24 times an
                 encoder pass above 1024 frames and never at 600 (these
                 launches go into the ``kernels`` line as
                 ``flash_prefill_noncausal``; the fp32 check's as
                 ``..._fp32``), the encoder's device split at 4096, and
                 the fp32 decode-vs-prefill check at 1500 frames. griffin's
                 and seamless's attention is tempered (STATE_TEMPERED).
                 The kernels phase holds K4 non-causal at seamless's heads
                 (S = T = 1500 and 4096, 16/16, hd 64) in both dtypes.
12. ``train``  — the training path, one JSON line a sub-phase.
                 ``train_main``: full-width, full-depth qwen3-1.7b in
                 bfloat16 over fp32 masters, B=2, S=1024, 8 steps of
                 launch/train.py's loop on the copy task (one batch from
                 seed 0, lr TRAIN_LR, warm-up 1): losses finite and falling,
                 step 8; the state saved at step 4 (build/train_ckpt/,
                 deleted after) with a digest of each leaf, loaded once
                 into an abstract_train_state template on the card, held
                 to those digests bit for bit, and steps 5-8 resumed from
                 it within 1e-3 of the uninterrupted losses; the median
                 step wall of steps 2-8, tokens/s, MFU, peak memory, and one
                 step's device time by part (GEMMs, attention,
                 cross-entropy, optimizer, rest) beside the FLOP and
                 optimizer-bytes bounds. ``train_flash``: S=2048 (the
                 chunked flash path), B=1, remat "full", one full-depth step
                 (finite loss, finite non-zero grad norm); then 4 layers
                 under remat none / full / dots, losses within 1e-6 and grad
                 norms within 1e-4 relative, each one's peak memory.
                 ``train_parity``: one fp32 step of qwen3-1.7b,
                 granite-moe-1b-a400m, mamba2-370m, recurrentgemma-2b and
                 seamless-m4t-large-v2 at full width (cut in depth) on the
                 card against the same step on the CPU from the same
                 weights: loss within 1e-5 relative, every grad leaf within
                 1e-3 of its max |g|, the updated master within 1e-6;
                 granite's, recurrentgemma's and seamless's attention
                 tempered. K4 and K3 launch no time in the whole phase.
13. ``dryrun`` — the dry-run accounting (``launch/dryrun.py``). First
                 three cells of full-width, full-depth qwen3-1.7b (bf16,
                 seed 0) cut only in batch run on the card, alone (their
                 steps are host-bound): prefill_32k at B=1, decode_32k at B=8 and
                 train_4k at B=1 under remat "full". Each holds the
                 allocator's growth for its resident tensors (params, + the
                 cache, or the train state) within RESIDENT_REL of the
                 predicted bytes, the FLOPs counted at that shape over
                 one step's device time (torch.profiler) to at most
                 FLOP_SHARE_MAX of 989 TFLOP/s and the bytes counted to at
                 most BYTE_SHARE_MAX of 3.35 TB/s; it prints the step's peak
                 beside resident + predicted temp bytes and the roofline's
                 time beside the device time and the wall. Then every
                 (arch x shape) cell on both production meshes and the ten
                 transfer cells are traced on the meta device in a pool of
                 spawned processes (one trace an (arch, shape), shared by
                 its meshes), with the three cells' predictions; one line a
                 cell (FLOPs per chip, resident bytes per device, roofline
                 terms, bottleneck); a failed cell fails the phase. Beside
                 the pool, K4 bf16 cold at S = T = 32,768: its first and
                 last 256 rows against the plain version computing just
                 those rows, within K4's bf16 tolerance, timed beside SDPA;
                 the fp32 kernel's split workspace at that shape is stated,
                 not run.

The weights are random, made from a seed. The last lines are the kernels
summary, the nvidia-smi line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
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
    rows.update(_tp_kernel_cases(torch, peaks, gen, flush))
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

    nb = 512
    main = None
    layer = L * 3 // 5
    for dtype in (torch.float32, torch.bfloat16):
        pspec = KVCacheSpec(num_layers=L, num_blocks=nb, block_size=bs,
                            num_kv_heads=KV, head_dim=hd, dtype=dtype)
        kpool = torch.randn(pspec.shape, generator=gen, device=DEVICE).to(dtype)
        for B, lens, W in K3_CASES:
            row = _k3_case(torch, peaks, gen, flush, kpool, pspec, layer, H, B, lens, W)
            if dtype == torch.bfloat16 and B == 4:
                main = dict(row, shape=f"B=4 bf16 (the e2e decode step), lengths {lens}, W={W}")
        del kpool
    return main


def _k3_case(torch, peaks, gen, flush, kpool, pspec, layer, H, B, lens, W, tag=None) -> dict:
    """One K3 call against its plain version (and, in bf16, the plain
    version on the upcast values), times and bound; at B=8 every row is
    also held bit-identical to the same row alone."""
    from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                     paged_decode_attention_stats_ref)

    dtype, bs, KV, hd = pspec.dtype, pspec.block_size, pspec.num_kv_heads, pspec.head_dim
    nb = pspec.num_blocks
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
    check(ok, f"K3 disagrees ({dtype}, B={B}, H {H} KV {KV} hd {hd}): out {err}, m {err_m}, "
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
    emit("kernels", kernel="paged_decode_attention", case=tag, dtype=str(dtype), batch=B,
         heads=[H, KV, hd], lengths=lens, table_width=W, max_abs_err=err, m_err=err_m,
         l_rel_err=err_l, vs_upcast_err=up_err, length0_ok=zero_ok,
         rows_alone_bit_identical=identical, ms=t3, device_only_ms=t3d, plain_ms=t3p,
         faster_than_plain=t3 < t3p, bound_ms=b3, bound_by=b3_by,
         bound_share=b3 / t3, bytes=nbytes)
    return dict(max_abs_err=err, ms=t3, device_only_ms=t3d, plain_ms=t3p, library_ms=None,
                bound_ms=b3, bound_by=b3_by)


def _sdpa(torch, q, k, v, q_offset, causal=True):
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
                                                  is_causal=causal and mask is None,
                                                  enable_gqa=True)


def _k4_cases(torch, peaks, gen, flush) -> dict:
    """K4 against its plain version: cold S = T = 1500 and suffix S = 400
    over T = 1456 at qwen3-1.7b's heads, gemma-2b's heads (hd 256, KV 1,
    H 8) cold at 1024 and stablelm-12b's (hd 160, KV 8, H 32) cold at 1500
    and suffix 400 over 1456, in float32 and bfloat16; in bfloat16 also
    sim_calibrate's shapes: its sweep's longest prompt (cold 4096), a
    prompt below flash_threshold (cold 256) and the parity run's follower
    (suffix 200 over 1256); and the suffix rows bit-identical to the same
    rows of the cold call, at qwen3-1.7b's and stablelm-12b's heads."""
    both = (torch.float32, torch.bfloat16)
    cases = [(both, "cold", 1500, 0, 16, 8, 128), (both, "suffix", 400, 1056, 16, 8, 128),
             (both, "cold gemma-2b heads", 1024, 0, 8, 1, 256),
             (both, "cold stablelm-12b heads", 1500, 0, 32, 8, 160),
             (both, "suffix stablelm-12b heads", 400, 1056, 32, 8, 160),
             ((torch.bfloat16,), "cold, the sweep's longest", 4096, 0, 16, 8, 128),
             ((torch.bfloat16,), "cold, below flash_threshold", 256, 0, 16, 8, 128),
             ((torch.bfloat16,), "suffix, the parity follower", 200, 1056, 16, 8, 128)]
    mains = {}
    for dtype in both:
        for dtypes, tag, s, off, H, KV, hd in cases:
            if dtype not in dtypes:
                continue
            row = _k4_case(torch, peaks, gen, flush, dtype, tag, s, off, H, KV, hd)
            if tag == "cold":
                name = "flash_prefill" if dtype == torch.bfloat16 else "flash_prefill_fp32"
                mains[name] = row
    # row independence: rows 1056.. of the cold call == the suffix call's rows
    for dtype in both:
        _k4_rows_identical(torch, gen, dtype, 1456, 16, 8, 128, (1056, 1000, 1455))
        _k4_rows_identical(torch, gen, dtype, 1456, 32, 8, 160, (1056, 1455))
    # non-causal, at seamless-m4t-large-v2's encoder heads (e2e_state)
    for dtype in both:
        for s in SEAMLESS_K4_LENS:
            row = _k4_case(torch, peaks, gen, flush, dtype, "non-causal, seamless encoder",
                           s, 0, 16, 16, 64, causal=False)
            if s == max(SEAMLESS_K4_LENS):
                name = "flash_prefill_noncausal" + ("" if dtype == torch.bfloat16 else "_fp32")
                mains[name] = row
    return mains


def _k4_case(torch, peaks, gen, flush, dtype, tag, s, off, H, KV, hd, causal=True) -> dict:
    """One K4 call against its plain version (and, in bf16, the plain
    version on the upcast values), with its times, bound and SDPA's time."""
    from repro_torch.kernels.flash_prefill import flash_prefill_op, flash_prefill_ref
    from repro_torch.kernels.flash_prefill.ops import launch_plan

    t = s + off
    mk = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
    q, k, v = mk(1, s, H, hd), mk(1, t, KV, hd), mk(1, t, KV, hd)
    out = flash_prefill_op(q, k, v, causal=causal, q_offset=off)
    same = flash_prefill_ref(q, k, v, causal=causal, q_offset=off)
    sync(torch)
    err = float((out.float() - same.float()).abs().max())
    if dtype == torch.float32:
        up_err, ok = err, err <= K4_FP32_TOL
    else:
        up = flash_prefill_ref(q.float(), k.float(), v.float(), causal=causal, q_offset=off)
        d = (out.float() - up).abs()
        up_err = float(d.max())
        ok = err <= K4_BF16_TOL and bool((d <= up.abs() * 2.0 ** -8 + 1e-5).all())
        del up, d
    check(ok, f"K4 disagrees ({dtype}, {tag}): {err} vs plain, {up_err} vs upcast")
    pairs = s * off + s * (s + 1) // 2 if causal else s * t
    esz = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
    key = "fp32" if dtype == torch.float32 else "bf16"
    b4, b4_by = bound_ms(nbytes, 4 * hd * H * pairs, peaks, key)
    t4 = time_ms(torch, lambda: flash_prefill_op(q, k, v, causal=causal, q_offset=off),
                 flush=flush)
    t4p = time_ms(torch, lambda: flash_prefill_ref(q, k, v, causal=causal, q_offset=off),
                  reps=5, flush=flush)
    t4l = time_ms(torch, _sdpa(torch, q, k, v, off, causal), flush=flush)
    plan = None
    if dtype == torch.float32:      # the fp32 kernel's grid for this call
        plan = launch_plan(1, s, t, H, KV, hd, causal,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    emit("kernels", kernel="flash_prefill", case=tag, dtype=str(dtype), S=s, T=t,
         q_offset=off, causal=causal, heads=[H, KV, hd], max_abs_err=err, vs_upcast_err=up_err,
         ms=t4, plain_ms=t4p, library_ms=t4l, bound_ms=b4, bound_by=b4_by,
         flops=4 * hd * H * pairs, bytes=nbytes, tflops=4 * hd * H * pairs / t4 / 1e9,
         bound_share=b4 / t4, plan=plan)
    del q, k, v, out, same
    return dict(shape=f"{tag} S={s} T={t} {key}, H {H} KV {KV} hd {hd}",
                max_abs_err=err, ms=t4, plain_ms=t4p, library_ms=t4l,
                bound_ms=b4, bound_by=b4_by)


def _k4_rows_identical(torch, gen, dtype, t, H, KV, hd, offsets) -> None:
    """Rows off.. of a cold K4 call == the same rows of a suffix call."""
    from repro_torch.kernels.flash_prefill import flash_prefill_op

    name = "fp32" if dtype == torch.float32 else "bf16"
    mk = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE).to(dtype)  # noqa: E731
    q, k, v = mk(1, t, H, hd), mk(1, t, KV, hd), mk(1, t, KV, hd)
    cold = flash_prefill_op(q, k, v)
    identical = {}
    for off in offsets:
        identical[off] = bool(torch.equal(flash_prefill_op(q[:, off:], k, v, q_offset=off),
                                          cold[:, off:]))
    sync(torch)
    emit("kernels", kernel="flash_prefill", case=f"suffix rows == cold rows ({name})",
         T=t, heads=[H, KV, hd], offsets_bit_identical=identical)
    check(all(identical.values()),
          f"K4 {name} hd {hd}: suffix rows differ from its cold rows: {identical}")


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


PROFILE_PAD_S = 0.25       # idle before and after the work a profile counts


def device_launches(torch, fn) -> tuple:
    """``fn()`` under torch.profiler recording the device only, with the
    wrappers' counters set to 0 first: ``(fn's result, launch counts)``.
    A decode step replayed from a CUDA graph runs K3 and K1 without calling
    their wrappers, whose counters hold the host's calls (a capture's
    included), so K3's and K1's counts here are the device's records of
    their kernels, ``paged_decode`` and ``kv_transfer`` (less K5b's
    scatter and the fine-row moves, which run K1's kernels eagerly). The
    profiler keeps only the records inside its window, and the device's
    clock may run tens of ms from the host's, so the window is padded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launch_counts

    sync(torch)
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        out = fn()
        sync(torch)
        time.sleep(PROFILE_PAD_S)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    counts = launch_counts()
    k1 = sum("kv_transfer" in n for n in names)
    counts.update(paged_decode_attention=sum("paged_decode" in n for n in names),
                  kv_transfer=k1 - counts["kv_scatter"] - counts["kv_transfer_fine"])
    return out, counts


def run_cluster(torch, cfg, params, prompts, max_batch_tokens):
    """Serve the prompts through FlowKVClient on 1P+1D; returns (client,
    handles, launch counts of this run: ``device_launches``)."""
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1, num_blocks=256,
                          max_batch_tokens=max_batch_tokens, device=DEVICE)

    def serve():
        handles = [client.submit(p, SamplingParams(max_new_tokens=NEW_TOKENS))
                   for p in prompts]
        client.drain(max_cycles=500)
        return handles

    handles, counts = device_launches(torch, serve)
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
    layers = client.cluster.cfg.num_layers
    check(counts["paged_decode_attention"] == s["decode_steps"] * layers,
          f"{tag}: {counts['paged_decode_attention']} K3 runs for {s['decode_steps']} "
          f"steps of {layers} layers")
    check(k1_per_step(client.cluster, counts, s) == 1.0,
          f"{tag}: {k1_per_step(client.cluster, counts, s)} K1 appends a decode step")
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

    Step: see :func:`_step_profile` (the append rewrites the same slots, so
    the state does not change). Transfer: the K1 launch (CUDA events), the
    device verify's wall and the host blake2b digests' wall, separately.
    """
    from repro_torch.core.transfer import TransferPlanner
    from repro_torch.models import transformer as T
    from repro_torch.serving.kv_cache import PagedKVCache, spec_for_model

    kv, bt, tok, ln = _paged_state(torch, cfg, params, prompts, 1, 256)
    lens = [len(p) for p in prompts]
    out = {"step_batch": len(prompts), "step_lengths": lens}
    out.update(_step_profile(torch, lambda: T.decode_step_paged(params, cfg, tok, kv.pool,
                                                                bt, ln))[0])
    # one P->D transfer of the longest prompt: kernel time vs verification
    rid = max(range(len(prompts)), key=lambda i: lens[i])
    dst = PagedKVCache(spec_for_model(cfg, 256), device=DEVICE)
    dst_blocks = dst.bm.allocate(0, lens[rid] + 1)
    plan = TransferPlanner(kv.spec).plan("flowkv", kv.bm.get(rid)[:len(dst_blocks)], dst_blocks)
    out.update(transfer_tokens=lens[rid], **_transfer_split(torch, kv, dst, plan))
    return out


def _step_profile(torch, step) -> tuple:
    """A decode step's median wall over 10 synchronized calls (after 3 warm
    ones) and its device time by kernel over 3 profiled calls, with K3's
    time and share; returns (summary, device us by kernel over the 3)."""
    for _ in range(3):
        step()
    sync(torch)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        sync(torch)
        walls.append(time.perf_counter() - t0)
    by_kernel, wall = _profiled(torch, step)
    total = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:8]
    k3_us = sum(v for k, v in by_kernel.items() if "paged_decode" in k)   # every K3 kernel
    return dict(step_wall_ms=statistics.median(walls) * 1e3, step_device_ms=total / 3e3,
                step_profiled_wall_ms=wall / 3 * 1e3, k3_ms=k3_us / 3e3,
                k3_share=k3_us / total if total else None,
                step_device_busy_share=(total / 1e6) / wall if wall else None,
                step_top_kernels_ms=[(k[:80], v / 3e3) for k, v in top]), by_kernel


def _profiled(torch, fn, n: int = 3) -> tuple:
    """Device microseconds by kernel over ``n`` calls of ``fn`` under
    torch.profiler, and those calls' wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync(torch)
        wall = time.perf_counter() - t0
    return _device_by_kernel(prof), wall


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
    on the decode node; returns (cluster, requests, launch counts
    (``device_launches``), span recorder, per-request fetch walls)."""
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

    def serve():
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

    _, counts = device_launches(torch, serve)
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
    from repro_torch.kernels.kv_gather import kv_transfer, kv_transfer_ref, ops
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
    row_bytes = spec.payload * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["design"] = {name: dataclasses.asdict(ops.k1_design(row_bytes, 0, *sides, n_, sms))
                     for name, sides, n_ in (("demote", (False, True), int(dsp.numel())),
                                             ("promote", (True, False), int(usp.numel())))}
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
# e2e_fleet: the Load-Aware Scheduler on real engines (role flips, local
# handoffs, overload admission, decode preemption)
# ---------------------------------------------------------------------------
FLEET_PROMPTS, FLEET_LENS = 16, (1100, 2000)   # a prefill-heavy burst, all above flash_threshold
FLEET_NEW = 8
FLEET_WAVE = 8                         # prompts at cycle 0; the rest arrive one a cycle
FLEET_BATCH_TOKENS = 2048              # about one prompt a cycle a prefill node
FLEET_IDLE = 40                        # idle cycles for the flips to revert
FLEET_HW = ("h100", "h20", "h100", "a100")      # declared per node (sim/hardware.py)
FLEET_HANDOFFS = 2                     # prompts served on the all-prefill fleet
OVERLOAD_PROMPTS = 12
OVERLOAD_POLICY = dict(max_queue_depth=2, max_defer_cycles=3, retry_after_floor_s=2.0)
DEFER_PROMPTS = 3
PREEMPT_LEN, PREEMPT_NEW = 1000, 64


def preempt_blocks(bs: int) -> int:
    """The smallest pool that admits two PREEMPT_LEN prompts at once: each
    holds ceil((PREEMPT_LEN + 1) / bs) blocks after its prefill (32 at 32),
    and decoding PREEMPT_NEW tokens grows each to
    ceil((PREEMPT_LEN + PREEMPT_NEW) / bs) (34), so two cannot both finish."""
    admit = -(-(PREEMPT_LEN + 1) // bs)
    check(-(-(PREEMPT_LEN + PREEMPT_NEW) // bs) > admit, "e2e_fleet: the pool never fills")
    return 2 * admit


class FleetProbe:
    """Counts and times the serving path of one FlowKVClient without
    changing it: each engine's prefill and decode calls (K4 / K5b launches
    and the node's role at the call), each P->D handoff (K1 launches,
    local or remote) and each spill and restore (K5a / K5b launches, the
    saved bytes, where they landed)."""

    def __init__(self, torch, client):
        from repro_torch.kernels import launch_counts

        self.torch, self.counts, self.ctl = torch, launch_counts, client.controller
        self.prefills, self.decode_walls, self.handoffs = [], [], []
        self.spills, self.restores = [], []
        cluster = client.cluster
        for nid, eng in cluster.engines.items():
            eng.run_prefill = self._prefill(nid, eng.run_prefill)
            eng.run_decode = self._decode(eng.run_decode)
            sched = eng.scheduler
            sched.on_spill = self._spill(eng, sched.on_spill)
            sched.on_resume = self._restore(eng, sched.on_resume)
        cluster._transfer = self._handoff(cluster._transfer)

    def _delta(self, fn, *keys):
        before = self.counts()
        t0 = time.perf_counter()
        out = fn()
        sync(self.torch)
        wall = time.perf_counter() - t0
        after = self.counts()
        return out, wall, {k: after[k] - before[k] for k in keys}

    def _prefill(self, nid, run):
        def wrapped(decision, now=None):
            role = self.ctl.nodes[nid].role
            out, wall, d = self._delta(lambda: run(decision, now=now), "flash_prefill",
                                       "kv_scatter")
            self.prefills.append(dict(cycle=self.ctl.cycle, node=nid, role=role,
                                      home=self.ctl.nodes[nid].home_role, wall_s=wall,
                                      tokens=decision.num_prefill_tokens, **d))
            return out
        return wrapped

    def _decode(self, run):
        def wrapped(decision):
            out, wall, _ = self._delta(lambda: run(decision))
            self.decode_walls.append(wall)
            return out
        return wrapped

    def _handoff(self, transfer):
        def wrapped(req):
            src = req.prefill_node
            _, wall, d = self._delta(lambda: transfer(req), "kv_transfer")
            self.handoffs.append(dict(request=req.request_id, src=src, dst=req.decode_node,
                                      local=src == req.decode_node, wall_s=wall,
                                      k1=d["kv_transfer"],
                                      dispatches=req.transfer_dispatches))
            return None
        return wrapped

    def _spill(self, eng, hook):
        def wrapped(req):
            _, wall, d = self._delta(lambda: hook(req), "kv_gather")
            k, v, length = eng.spilled[req.request_id]
            self.spills.append(dict(request=req.request_id, cycle=self.ctl.cycle,
                                    tokens=length, wall_s=wall, k5a=d["kv_gather"],
                                    bytes=k.numel() * k.element_size() * 2,
                                    on=str(k.device)))
        return wrapped

    def _restore(self, eng, hook):
        def wrapped(req):
            had = req.request_id in eng.spilled
            _, wall, d = self._delta(lambda: hook(req), "kv_scatter")
            self.restores.append(dict(request=req.request_id, cycle=self.ctl.cycle,
                                      spilled=had, wall_s=wall, k5b=d["kv_scatter"]))
        return wrapped


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(xs, q)) if xs else None


def _fleet_summary(client, probe, handles, wall, busy) -> dict:
    reqs = [h.request for h in handles]
    ttft = [r.first_token_wall - r.arrival_wall for r in reqs if r.first_token_wall]
    dec = [w * 1e3 for w in probe.decode_walls]
    local = [h for h in probe.handoffs if h["local"]]
    return dict(
        serve_wall_s=wall, cycles=client.controller.cycle, requests=len(reqs),
        ttft_wall_p50_s=_pct(ttft, 50), ttft_wall_p95_s=_pct(ttft, 95),
        decode_step_wall_p50_ms=_pct(dec, 50), decode_step_wall_p95_ms=_pct(dec, 95),
        decode_steps=len(dec), local_handoffs=len(local),
        remote_handoffs=len(probe.handoffs) - len(local),
        events=[(e.cycle, e.kind, e.detail) for e in client.controller.events],
        device_busy_share=busy)


def _device_busy(torch, fn) -> tuple:
    """``fn()`` under torch.profiler recording the device only: its wall and
    the device's busy seconds (kernels and copies) in that wall. It sums
    the raw trace records: building key_averages() over a serve's ~10^5
    kernels takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch)
        wall = time.perf_counter() - t0
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9
    return wall, busy


def _fleet_serve(torch, client, drive):
    """``drive()`` profiled (``_device_busy``): its wall, the device's busy
    share over it, and its launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    sync(torch)
    reset_launch_counts()
    wall, busy = _device_busy(torch, drive)
    return wall, busy / wall if wall else None, launch_counts()


def _fleet_check_handoffs(tag, probe):
    for h in probe.handoffs:
        want = 0 if h["local"] else h["dispatches"]
        check(h["k1"] == want and (h["local"] or h["dispatches"] == 1),
              f"{tag}: handoff {h} launched {h['k1']} K1 for {h['dispatches']} dispatches")


def _fleet_no_leaks(tag, client, blocks):
    for nid, eng in client.cluster.engines.items():
        eng.scheduler.bm.check_invariants()
        check(eng.scheduler.bm.free_capacity == blocks,
              f"{tag}: node {nid} has {eng.scheduler.bm.free_capacity} of {blocks} blocks free")
        check(not eng.spilled, f"{tag}: node {nid} keeps spills {list(eng.spilled)}")
    check(client.cluster.audit_blocks() == 0, f"{tag}: leaked blocks")


def _fleet_tokens(tag, handles, mono, new):
    for h in handles:
        r = h.request
        check(list(map(int, r.output_tokens)) == mono(r.prompt_tokens, new),
              f"{tag}: request {r.request_id} differs from monolithic greedy_generate")


def _fleet_imbalance(torch, cfg, params, prompts, mono, blocks) -> dict:
    """Run a: 1P+3D with the flip policy under a prefill-heavy burst, the
    idle cycles that revert it, then every node flipped to prefill by the
    client for FLEET_HANDOFFS prompts handed off on their own node."""
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams
    from repro_torch.sim.hardware import get_hardware

    tag = "e2e_fleet imbalance"
    hw = {i: get_hardware(n) for i, n in enumerate(FLEET_HW)}
    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=3, num_blocks=blocks,
                          max_batch_tokens=FLEET_BATCH_TOKENS, role_flip=True, hardware=hw,
                          device=DEVICE)
    probe = FleetProbe(torch, client)
    ctl = client.controller
    home = {nid: n.role for nid, n in ctl.nodes.items()}
    caps = ctl._capabilities()
    sp = SamplingParams(max_new_tokens=FLEET_NEW)
    burst = prompts[:FLEET_PROMPTS]
    handles = []

    def drive():
        handles.extend(client.submit(p, sp) for p in burst[:FLEET_WAVE])
        for p in burst[FLEET_WAVE:]:
            client.step()
            handles.append(client.submit(p, sp))
        client.drain(max_cycles=400)

    wall, busy, counts = _fleet_serve(torch, client, drive)
    check(all(h.request.state.value == "finished" for h in handles), f"{tag}: unfinished")
    flips = [e for e in ctl.events if e.kind == "set_role"]
    to_prefill = [e for e in flips if e.detail.endswith("decode -> prefill")]
    check(bool(to_prefill), f"{tag}: no set_role moved a decode node to prefill")
    first = int(to_prefill[0].detail.split(":")[0].split()[1])
    richest = max((nid for nid, r in home.items() if r == "decode"), key=lambda n: caps[n][0])
    check(first == richest, f"{tag}: the first flip took node {first}, not node {richest}, "
          f"the most compute-rich decode node by _capabilities() {caps}")
    borrowed = [p for p in probe.prefills if home[p["node"]] == "decode"
                and p["role"] == "prefill"]
    check(any(p["flash_prefill"] > 0 and p["kv_scatter"] > 0 for p in borrowed),
          f"{tag}: no flipped node ran a prefill with K4 and K5b: {borrowed}")
    idle = 0
    while idle < FLEET_IDLE and any(n.role != home[nid] for nid, n in ctl.nodes.items()):
        client.step()
        idle += 1
    # home_role may stay equal to the home role: a node the reverse
    # (decode-hot) imbalance sent home keeps it set (ROADMAP queue 3)
    roles = {nid: (n.role, n.home_role, n.alive) for nid, n in ctl.nodes.items()}
    check(all(r == home[nid] and a and hr in (None, r) for nid, (r, hr, a) in roles.items()),
          f"{tag}: after {idle} idle cycles the roles are {roles}, home {home}")
    _fleet_tokens(tag, handles, mono, FLEET_NEW)
    _fleet_check_handoffs(tag, probe)
    _fleet_no_leaks(tag, client, blocks)
    data = dict(nodes="1P+3D", hardware=dict(enumerate(FLEET_HW)),
                capabilities={n: list(c) for n, c in caps.items()}, launches=counts,
                first_flip=first, idle_cycles_to_revert=idle, roles_after=roles,
                prefills_on_flipped=[{k: p[k] for k in ("cycle", "node", "tokens",
                                                        "flash_prefill", "kv_scatter")}
                                     for p in borrowed],
                **_fleet_summary(client, probe, handles, wall, busy))

    # every node prefill: routing falls back to hybrid nodes and hands the
    # cache off on the node that prefilled it (no K1)
    for nid, r in home.items():
        if r == "decode":
            client.set_role(nid, "prefill")
    probe.handoffs.clear()
    more = prompts[FLEET_PROMPTS:FLEET_PROMPTS + FLEET_HANDOFFS]
    local = []

    def drive_local():
        local.extend(client.submit(p, sp) for p in more)
        client.drain(max_cycles=100)

    lwall, lbusy, lcounts = _fleet_serve(torch, client, drive_local)
    for nid, r in home.items():
        client.set_role(nid, r)
    check(len(probe.handoffs) == len(more) and all(h["local"] for h in probe.handoffs),
          f"{tag}: the all-prefill fleet's handoffs {probe.handoffs}")
    _fleet_check_handoffs(tag, probe)
    _fleet_tokens(tag, local, mono, FLEET_NEW)
    _fleet_no_leaks(tag, client, blocks)
    k1 = sum(h["k1"] for h in probe.handoffs)
    data["all_prefill"] = dict(serve_wall_s=lwall, device_busy_share=lbusy, launches=lcounts,
                               handoffs=probe.handoffs, handoff_k1=k1,
                               decode_nodes=[h.request.decode_node for h in local])
    return data


def _fleet_overload(torch, cfg, params, prompts, mono, blocks) -> dict:
    """Run b: 1P+1D under the admission gate. A burst of OVERLOAD_PROMPTS
    is partly rejected with a retry-after; after the back-off the rejected
    prompts are resubmitted (and again after each reject) until served.
    Then a gate that defers for up to 200 cycles serves DEFER_PROMPTS
    without a reject."""
    import math

    from repro_torch.core.scheduler import AdmissionPolicy
    from repro_torch.obs.tracing import attach_tracer
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    tag = "e2e_fleet overload"
    sp = SamplingParams(max_new_tokens=FLEET_NEW)
    out = {}
    for run, n, policy in (("reject", OVERLOAD_PROMPTS, AdmissionPolicy(**OVERLOAD_POLICY)),
                           ("defer", DEFER_PROMPTS,
                            AdmissionPolicy(max_queue_depth=2, max_defer_cycles=200))):
        client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1,
                              num_blocks=blocks, max_batch_tokens=FLEET_BATCH_TOKENS,
                              admission=policy, device=DEVICE)
        rec = attach_tracer(client.cluster)
        probe = FleetProbe(torch, client)
        handles, retried, backoffs, pending = [], [], [], []

        def drive():
            handles.extend(client.submit(p, sp) for p in prompts[:n])
            client.drain(max_cycles=500)
            pending[:] = [h for h in handles if h.rejected]
            for _ in range(n):                 # the client's back-off loop
                if not pending:
                    break
                wait = max(math.ceil(h.retry_after) for h in pending)
                backoffs.append(wait)
                for _ in range(wait):
                    client.step()
                again = [client.submit(h.request.prompt_tokens, sp) for h in pending]
                retried.extend(again)
                client.drain(max_cycles=500)
                pending[:] = [h for h in again if h.rejected]

        wall, busy, counts = _fleet_serve(torch, client, drive)
        rejected = [h for h in handles if h.rejected]
        served = [h for h in handles + retried if not h.rejected]
        st = client.stats()
        check(all(h.request.state.value == "finished" for h in served), f"{tag}: unfinished")
        check(st["deferred"] == 0, f"{tag} {run}: {st['deferred']} still deferred")
        n_rejected = sum(1 for h in handles + retried if h.rejected)
        check(st["rejected"] == n_rejected,
              f"{tag} {run}: stats rejected {st['rejected']} != {n_rejected}")
        deferred = [e for e in client.controller.events if e.kind == "admission"
                    and e.detail.startswith("deferred")]
        if run == "reject":
            check(0 < len(rejected) < len(handles),
                  f"{tag}: {len(rejected)} of {len(handles)} rejected")
            for h in rejected:
                check(h.done and h.retry_after is not None and h.retry_after >= 2.0
                      and bool(h.stats()["reject_reason"]) and list(h.tokens()) == []
                      and not h.cancel(), f"{tag}: rejected handle {h.stats()}")
            check(not pending and {tuple(h.request.prompt_tokens) for h in retried
                                   if not h.rejected}
                  == {tuple(h.request.prompt_tokens) for h in rejected},
                  f"{tag}: the resubmissions were not all served")
        else:
            check(bool(deferred) and n_rejected == 0,
                  f"{tag} defer: {len(deferred)} deferrals, {n_rejected} rejects")
        _fleet_tokens(f"{tag} {run}", served, mono, FLEET_NEW)
        _fleet_check_handoffs(f"{tag} {run}", probe)
        _fleet_no_leaks(f"{tag} {run}", client, blocks)
        # the gate's TTFT price (the data-sheet H100 profile) beside the wall
        admitted = {}
        for s in rec.spans:
            if s.name == "admission" and s.attrs.get("verdict") == "admitted":
                admitted[s.trace_id] = s.attrs["predicted_ttft_s"]
        ttft = [dict(request=h.request_id, prompt_len=h.request.prompt_len,
                     predicted_s=admitted.get(h.request_id),
                     wall_s=h.request.first_token_wall - h.request.arrival_wall)
                for h in served]
        ratios = [t["wall_s"] / t["predicted_s"] for t in ttft if t["predicted_s"]]
        out[run] = dict(prompts=n, policy=dict(dataclasses.asdict(policy)),
                        rejected=len(rejected), rejected_total=n_rejected,
                        deferred=len(deferred), resubmitted=len(retried),
                        backoff_cycles=backoffs, launches=counts,
                        retry_after_s=[h.retry_after for h in rejected],
                        reject_reasons=sorted({h.request.reject_reason for h in rejected}),
                        ttft_predicted_vs_wall=ttft,
                        ttft_wall_over_predicted=[min(ratios), max(ratios)] if ratios else None,
                        **_fleet_summary(client, probe, handles + retried, wall, busy))
        del client, probe, handles, retried, pending, rec
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _fleet_preempt(torch, cfg, params, mono) -> dict:
    """Run c: 1P+1D on the smallest pool that admits two PREEMPT_LEN prompts
    (``preempt_blocks``): decoding PREEMPT_NEW tokens each swaps one out
    (its K/V gathered by K5a and copied to the host) and back in (K5b).
    Then two more prompts, and the one swapped out is cancelled while
    SWAPPED."""
    import numpy as np

    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    tag = "e2e_fleet preempt"
    blocks = preempt_blocks(cfg.block_size)
    rng = np.random.RandomState(SEED + 23)
    prompts = [rng.randint(0, cfg.vocab_size, size=PREEMPT_LEN).tolist() for _ in range(4)]
    sp = SamplingParams(max_new_tokens=PREEMPT_NEW)
    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1, num_blocks=blocks,
                          max_batch_tokens=FLEET_BATCH_TOKENS, device=DEVICE)
    probe = FleetProbe(torch, client)
    handles, swapped_cycles = [], []

    def drive():
        handles.extend(client.submit(p, sp) for p in prompts[:2])
        for _ in range(400):
            client.step()
            swapped_cycles.append(sum(h.state.value == "swapped" for h in handles))
            if all(h.done for h in handles):
                break

    wall, busy, counts = _fleet_serve(torch, client, drive)
    check(sum(swapped_cycles) > 0, f"{tag}: no request was ever SWAPPED on {blocks} blocks")
    check(bool(probe.spills) and all(s["k5a"] >= 1 and s["on"] == "cpu" for s in probe.spills),
          f"{tag}: spills {probe.spills}")
    restored = [r for r in probe.restores if r["spilled"]]
    check(len(restored) == len(probe.spills) and all(r["k5b"] >= 1 for r in restored),
          f"{tag}: restores {probe.restores} for spills {probe.spills}")
    check(all(h.request.retries == 0 for h in handles), f"{tag}: retries")
    _fleet_tokens(tag, handles, mono, PREEMPT_NEW)
    _fleet_no_leaks(tag, client, blocks)
    data = dict(pool_blocks=blocks, prompt_len=PREEMPT_LEN, new_tokens=PREEMPT_NEW,
                swapped_cycles=sum(swapped_cycles), spills=list(probe.spills),
                restores=restored, launches=counts,
                **_fleet_summary(client, probe, handles, wall, busy))

    # cancel while SWAPPED: the spill is dropped, nothing leaks
    more = [client.submit(p, sp) for p in prompts[2:]]
    target = None
    for _ in range(400):
        client.step()
        target = next((h for h in more if h.state.value == "swapped"), None)
        if target is not None or all(h.done for h in more):
            break
    check(target is not None, f"{tag}: the third request was never SWAPPED")
    dnode = client.cluster.engines[target.request.decode_node]
    check(target.request_id in dnode.spilled, f"{tag}: the swapped request has no spill")
    check(target.cancel() and target.request_id not in dnode.spilled,
          f"{tag}: cancel kept the spill")
    client.drain(max_cycles=400)
    _fleet_tokens(tag, [h for h in more if h is not target], mono, PREEMPT_NEW)
    _fleet_no_leaks(tag + " cancel", client, blocks)
    data["cancel_while_swapped"] = dict(request=target.request_id,
                                        cancelled_at_cycle=client.controller.cycle,
                                        state=target.state.value)
    return data


def phase_e2e_fleet(torch, env) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_model

    tag = "e2e_fleet"
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), dtype=torch.float32)
    params = get_model(cfg).init(SEED, DEVICE)
    rng = np.random.RandomState(SEED + 13)
    # lengths first, so they do not depend on the vocabulary (the CPU
    # emulation, tools/fleet_emulate.py, serves the same lengths)
    lens = rng.randint(FLEET_LENS[0], FLEET_LENS[1] + 1, size=FLEET_PROMPTS + FLEET_HANDOFFS)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    # a P->D handoff into a pool without room raises (ROADMAP queue 3), and
    # the router may send the whole burst to one decode node: every node
    # holds every burst prompt's blocks to its last token
    blocks = sum(-(-(len(p) + FLEET_NEW) // cfg.block_size) for p in prompts)
    greedy, mono_s = {}, [0.0]

    def mono(prompt, new):
        key = (tuple(prompt), new)
        if key not in greedy:
            t0 = time.perf_counter()
            tok = torch.tensor([list(prompt)], dtype=torch.int32, device=DEVICE)
            greedy[key] = [int(x) for x in T.greedy_generate(params, cfg, tok, new)[0].cpu()]
            mono_s[0] += time.perf_counter() - t0
        return greedy[key]

    data = dict(model=cfg.name, dtype=str(cfg.dtype), layers=cfg.num_layers,
                prompt_lens=[len(p) for p in prompts], new_tokens=FLEET_NEW,
                max_batch_tokens=FLEET_BATCH_TOKENS, pool_blocks=blocks)
    data["imbalance"] = _fleet_imbalance(torch, cfg, params, prompts, mono, blocks)
    gc.collect()
    torch.cuda.empty_cache()
    data["overload"] = _fleet_overload(torch, cfg, params, prompts, mono, blocks)
    data["preempt"] = _fleet_preempt(torch, cfg, params, mono)
    data.update(card=env["smi"], monolithic_s=mono_s[0], phase_s=time.perf_counter() - t_phase)
    emit(tag, **data)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# e2e_moe_tp: MoE and tensor/expert-parallel serving (granite-moe-1b-a400m)
# ---------------------------------------------------------------------------
MOE_ARCH = "granite-moe-1b-a400m"
MOE_NEW_TOKENS = 8
MOE_BLOCKS = 192                       # pool blocks a node: 576 MiB of fp32 K/V
MOE_TP = ({0: 1, 1: 1}, {0: 2, 1: 2}, {0: 2, 1: 4})
MOE_TIMED_TP = ({0: 1, 1: 1}, {0: 2, 1: 4})
# The random weights of the gate: the port's init from SEED with wq / wk
# scaled by sqrt(3)/8 and wv by 1/8. At the init's own scale (dense_init
# reads the heads axis of wq / wk / wv as their fan-in) granite, which has no
# qk-norm, attends with scores of std ~90: near one-hot softmaxes whose
# near-ties amplify fp32 summation-order differences through 24 layers until
# the same state decodes to other logits on the paged and the dense path
# (tools/moe_conditioning_probe.py). Tempered to std ~4 the model stays
# well conditioned while attention still dominates the residual stream, and
# its greedy streams do not collapse to one repeated token.
MOE_ATTN_SCALE = {"wq": 3 ** 0.5 / 8, "wk": 3 ** 0.5 / 8, "wv": 1 / 8}
MOE_MIN_DISTINCT = 4                   # distinct tokens of 8 in every monolithic stream
# max |delta logit| (fp32) on one state. A shard's narrower GEMMs may take
# other cuBLAS algorithms, so the bar is not bit identity. Each limit sits
# between the sound paths' readings and a planted fault's (shard 1's K3 or
# K4 output rounded to bf16 at TP 2), which the phase also takes every run.
MOE_STEP_TOL = 1e-3                    # a decode step: paged vs dense, TP 2 / 4 vs TP 1
MOE_PREFILL_TOL = 2e-2                 # the sharded prefill of 1100 tokens vs unsharded


def _block_a_row(row_bytes, align, src_on_host, dst_on_host, n, sms=132):
    """``ops.k1_design``'s signature over ``ops.block_a_row``: put in its
    place to serve with K1's design before the small-row one."""
    from repro_torch.kernels.kv_gather import ops

    return ops.block_a_row(row_bytes, align, n)


def _tp_kernel_cases(torch, peaks, gen, flush) -> dict:
    """The kernels at the shapes of e2e_moe_tp and of the MoE/VLM configs:
    K1 over the fine (-1, hd) rows of a 1500-token granite-moe bf16 prompt
    moved TP 2 -> 4 (four shard pairs, bit-exact against the plain version,
    beside index_copy_ on the same rows); K3 at granite's heads as one shard
    sees them at TP 1 / 2 / 4 (B=4, hd 64), fp32 and bf16; K4 cold at
    granite's heads (S = T = 1500, hd 64) in both dtypes, bf16 at
    llama4-scout's heads (40/8, hd 128, S = 1500) and llava-next's (56/8,
    hd 128, its 2880 patches + 128 text tokens), and its suffix rows
    bit-identical to its cold rows at hd 64."""
    from repro_torch.configs import get_config
    from repro_torch.core.layout import KVCacheSpec
    from repro_torch.core.transfer import ShardedTransferEngine, ShardSpec, shard_pairs
    from repro_torch.kernels.kv_gather import kv_transfer_fine, kv_transfer_ref, ops

    cfg = get_config(MOE_ARCH)
    L, KV, hd, bs, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.block_size, cfg.num_heads
    bf16 = torch.bfloat16
    spec = KVCacheSpec(num_layers=L, num_blocks=MOE_BLOCKS, block_size=bs, num_kv_heads=KV,
                       head_dim=hd, dtype=bf16)
    n = spec.blocks_for_tokens(PROMPT_LENS[-1])
    src_blocks = list(range(3, 3 + n))
    dst_blocks = list(range(40, 40 + n // 2)) + list(range(120, 120 + n - n // 2))
    s_shard, d_shard = ShardSpec(2, KV), ShardSpec(4, KV)
    engine = ShardedTransferEngine(spec, spec, s_shard, d_shard)
    plan = engine.plan("flowkv", src_blocks, dst_blocks)
    table = plan.to_descriptors()

    def pools(tp):
        return [torch.randn((MOE_BLOCKS, L, 2, bs * (KV // tp) * hd), generator=gen,
                            device=DEVICE).to(bf16) for _ in range(tp)]

    src, dst0 = pools(2), pools(4)
    pairs = []
    for pair in shard_pairs(s_shard, d_shard):
        pairs.append((pair[0], pair[1], *engine.pair_rows(table, pair, DEVICE)))
    rows_n = sum(int(sp.numel()) for _, _, sp, _ in pairs)
    sflat = [p.view(-1, hd) for p in src]

    def kernel(dsts):
        for s, d, sp, dp in pairs:
            kv_transfer_fine(src[s], dsts[d], sp, dp, hd)

    def plain(dsts):
        for s, d, sp, dp in pairs:
            kv_transfer_ref(sflat[s], dsts[d].view(-1, hd), sp, dp)

    dk, dp_, de = ([p.clone() for p in dst0] for _ in range(3))
    kernel(dk)
    plain(dp_)
    engine.execute(plan, src, de)
    sync(torch)
    exact = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                and torch.equal(a.view(torch.int16), c.view(torch.int16))
                for a, b, c in zip(dk, dp_, de))
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(dk, dp_))
    kept = True
    for d in range(4):                     # rows no pair wrote keep their bytes
        mask = torch.ones(dk[d].numel() // hd, dtype=torch.bool, device=DEVICE)
        for _, dd, _, dp in pairs:
            if dd == d:
                mask[dp.long()] = False
        kept = kept and bool(torch.equal(dk[d].view(-1, hd)[mask].view(torch.int16),
                                         dst0[d].view(-1, hd)[mask].view(torch.int16)))
    check(exact and kept, f"K1 fine rows not bit-exact (exact={exact}, untouched kept={kept})")
    dflat = [p.view(-1, hd) for p in dk]
    lib_idx = [(s, d, sp.long(), dp.long()) for s, d, sp, dp in pairs]

    def library():
        for s, d, sp, dp in lib_idx:
            dflat[d].index_copy_(0, dp, sflat[s].index_select(0, sp))

    row_bytes = hd * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    designs = [ops.k1_design(row_bytes, src[s].data_ptr() | dk[d].data_ptr(), False, False,
                             int(sp.numel()), sms) for s, d, sp, _ in pairs]
    check(all(x.design == "rows" for x in designs), f"K1 fine rows took {designs}")

    def block_a_row(dsts):                 # the design the small-row kernel replaced
        for s, d, sp, dp in pairs:
            ops.kv_transfer_design(sflat[s], dsts[d].view(-1, hd), sp, dp,
                                   ops.block_a_row(row_bytes, 0, int(sp.numel())))

    old = [p.clone() for p in dst0]
    block_a_row(old)
    sync(torch)
    check(all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(old, dp_)),
          "K1 fine rows, one block a row: not bit-exact")
    t_k = time_ms(torch, lambda: kernel(dk), flush=flush)
    t_old = time_ms(torch, lambda: block_a_row(old), flush=flush)
    t_p = time_ms(torch, lambda: plain(dp_), flush=flush)
    t_l = time_ms(torch, library, flush=flush)
    t_d = device_only_ms(torch, lambda: kernel(dk), "kv_transfer_rows", flush=flush)
    t_old_d = device_only_ms(torch, lambda: block_a_row(old), "kv_transfer_kernel", flush=flush)
    t_plan = time_ms(torch, lambda: engine.execute(plan, src, de), reps=10, flush=flush)
    moved = 2 * rows_n * row_bytes + 2 * rows_n * 4
    b1, b1_by = bound_ms(moved, 0, peaks, "bf16")
    emit("kernels", kernel="kv_transfer_fine", case="TP 2 -> 4, 1500 tokens granite-moe bf16",
         pairs=len(pairs), rows=rows_n, row_bytes=row_bytes, bit_exact=exact,
         untouched_kept=kept, max_abs_err=err, ms=t_k, device_only_ms=t_d, plain_ms=t_p,
         library_ms=t_l, plan_with_tables_ms=t_plan, bound_ms=b1, bound_by=b1_by,
         bound_share=b1 / t_k, achieved_gbps=moved / t_k / 1e6, library_over_kernel=t_l / t_k,
         design=[dataclasses.asdict(x) for x in designs], rows_below=ops.ROWS_BELOW,
         block_a_row_ms=t_old, block_a_row_device_only_ms=t_old_d,
         block_a_row_over_small_rows=t_old / t_k)
    rows = {"kv_transfer_fine": dict(
        shape=f"TP 2 -> 4 fine rows of a {PROMPT_LENS[-1]}-token prompt: {len(pairs)} pairs, "
              f"{rows_n} rows x {row_bytes} B bf16", max_abs_err=err, ms=t_k,
        plain_ms=t_p, library_ms=t_l, bound_ms=b1, bound_by=b1_by)}
    del src, dst0, dk, dp_, de, sflat, dflat, lib_idx, pairs, old

    # -- K1 over the decode appends' short tables in e2e_moe_tp (B <= 4 lanes x
    # L layers x K/V rows of one shard's heads), as shipped beside the other
    # design: below ops.rows_from(width) rows they keep one block a row
    slots = MOE_BLOCKS * L * 2 * bs
    appends = {}
    for w in (KV // 4 * hd * 2, KV // 2 * hd * 2, KV * hd * 2):    # 256 / 512 / 1024 B
        for b in (1, 2, 4):
            rows_a = b * L * 2
            stage = torch.randint(0, 256, (rows_a, w), generator=gen, dtype=torch.uint8,
                                  device=DEVICE)
            slot = torch.zeros((slots, w), dtype=torch.uint8, device=DEVICE)
            sp = torch.arange(rows_a, dtype=torch.int32, device=DEVICE)
            dp = torch.randperm(slots, generator=gen, device=DEVICE)[:rows_a].to(torch.int32)
            want = slot.clone()
            kv_transfer_ref(stage, want, sp, dp)
            shipped = ops.k1_design(w, stage.data_ptr() | slot.data_ptr(), False, False,
                                    rows_a, sms)
            case = {"shipped": shipped.design, "rows_from": ops.rows_from(w)}
            for name, d in (("block_a_row", ops.block_a_row(w, 0, rows_a)),
                            ("rows", ops.rows_design(w, 16, rows_a, sms))):
                out_a = slot.clone()
                ops.kv_transfer_design(stage, out_a, sp, dp, d)
                sync(torch)
                check(torch.equal(out_a, want), f"K1 append {w} B x {rows_a} ({name}) not bit-exact")
                case[f"{name}_device_only_ms"] = device_only_ms(
                    torch, lambda: ops.kv_transfer_design(stage, out_a, sp, dp, d),
                    "kv_transfer_rows" if name == "rows" else "kv_transfer_kernel", flush=flush)
            appends[f"{w} B x {rows_a}"] = case
            del stage, slot, want, out_a
    emit("kernels", kernel="kv_transfer", case="e2e_moe_tp decode appends (short tables)",
         rows_below=ops.ROWS_BELOW, appends=appends)

    # -- K3 at a shard's heads: granite at TP 1 / 2 / 4, the decode step's B=4
    for dtype in (torch.float32, bf16):
        for tp in (1, 2, 4):
            pspec = KVCacheSpec(num_layers=L, num_blocks=256, block_size=bs,
                                num_kv_heads=KV // tp, head_dim=hd, dtype=dtype)
            kpool = torch.randn(pspec.shape, generator=gen, device=DEVICE).to(dtype)
            _k3_case(torch, peaks, gen, flush, kpool, pspec, L * 3 // 5, H // tp, 4,
                     PROMPT_LENS, 64, tag=f"granite-moe heads at TP {tp}")
            del kpool
    # -- K4 at granite's heads (hd 64) and at the MoE/VLM configs' G = 5 / 7
    for dtype in (torch.float32, bf16):
        _k4_case(torch, peaks, gen, flush, dtype, "cold granite-moe heads", 1500, 0, H, KV, hd)
    _k4_case(torch, peaks, gen, flush, bf16, "cold llama4-scout heads (G 5)", 1500, 0, 40, 8, 128)
    _k4_case(torch, peaks, gen, flush, bf16, "cold llava-next heads (G 7), 2880 patches + 128",
             2880 + 128, 0, 56, 8, 128)
    for dtype in (torch.float32, bf16):
        _k4_rows_identical(torch, gen, dtype, 1500, H, KV, hd, (1056, 1000, 1499))
    torch.cuda.empty_cache()
    return rows


def _moe_serve(torch, cfg, params, prompts, tp_degrees, max_batch_tokens, records=False):
    """Serve the prompts on 1P+1D at the given TP degrees through
    FlowKVClient; returns (client, handles, launch counts, wall seconds).
    With ``records`` the counts are ``device_launches``' and the wall holds
    the profiler's cost; without, they are the wrappers' (the host's
    calls)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1, num_blocks=MOE_BLOCKS,
                          max_batch_tokens=max_batch_tokens, tp_degrees=dict(tp_degrees),
                          device=DEVICE)

    def serve():
        handles = [client.submit(p, SamplingParams(max_new_tokens=MOE_NEW_TOKENS))
                   for p in prompts]
        client.drain(max_cycles=500)
        return handles

    sync(torch)
    t0 = time.perf_counter()
    if records:
        handles, counts = device_launches(torch, serve)
    else:
        reset_launch_counts()
        handles = serve()
        sync(torch)
        counts = launch_counts()
    return client, handles, counts, time.perf_counter() - t0


def _paged_state(torch, cfg, params, prompts, tp, num_blocks=MOE_BLOCKS):
    """The prompts prefilled (unsharded) into a pool of ``tp`` shards; the
    B = len(prompts) decode step's inputs, padded as the engine pads them."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import _next_pow2
    from repro_torch.serving.kv_cache import PagedKVCache, ShardedKVCache, spec_for_model

    spec = spec_for_model(cfg, num_blocks)
    kv = PagedKVCache(spec, device=DEVICE) if tp == 1 else \
        ShardedKVCache(spec, tp, device=DEVICE)
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
    pad = bt.shape[0] - b
    return (kv, bt.to(DEVICE), torch.tensor(toks + toks[:1] * pad, dtype=torch.int32,
                                            device=DEVICE),
            torch.tensor(lens + lens[:1] * pad, dtype=torch.int32, device=DEVICE))


def _step_fn(torch, cfg, params, kv, bt, tok, ln, tp):
    """One decode step on ``kv``: the unsharded step, or the sharded one on
    the engine's shard views and merged combine weights."""
    from repro_torch.distributed import tp as tp_mod
    from repro_torch.models import transformer as T

    if tp == 1:
        return lambda: T.decode_step_paged(params, cfg, tok, kv.pool, bt, ln)[0]
    shards = tp_mod.shard_params(params, cfg, tp)
    merged = tp_mod.merged_combine(shards, cfg)
    return lambda: tp_mod.sharded_decode_step_paged(shards, cfg, tok, kv.pools, bt, ln,
                                                    merged)[0]


def _moe_params(torch, cfg):
    """granite-moe's random weights: the port's init from SEED, the
    attention tempered by MOE_ATTN_SCALE."""
    from repro_torch.models.api import get_model

    params = get_model(cfg).init(SEED, DEVICE)
    for name, factor in MOE_ATTN_SCALE.items():
        params["layers"][name].mul_(factor)
    return params


def _monolithic(torch, cfg, params, prompts) -> list:
    """Each prompt's MOE_NEW_TOKENS tokens from greedy_generate (dense cache)."""
    from repro_torch.models import transformer as T

    return [[int(x) for x in T.greedy_generate(
        params, cfg, torch.tensor([p], dtype=torch.int32, device=DEVICE), MOE_NEW_TOKENS)[0].cpu()]
        for p in prompts]


def _first_steps(torch, cfg, params, prompts, tps) -> dict:
    """The first B = len(prompts) decode step's logits on one prefilled
    state: the paged step at each TP degree of ``tps``, and "dense", the
    monolithic decode_step on a dense cache of the same prefills."""
    from repro_torch.models import transformer as T

    b = len(prompts)
    steps = {}
    for tp in tps:
        kv, bt, tok, ln = _paged_state(torch, cfg, params, prompts, tp)
        steps[tp] = _step_fn(torch, cfg, params, kv, bt, tok, ln, tp)()[:b]
        del kv
    lens = [len(p) for p in prompts]
    cache = T.init_cache(cfg, b, max(lens) + 1, device=DEVICE)
    for i, p in enumerate(prompts):
        pre = T.prefill(params, cfg, torch.tensor([p], dtype=torch.int32, device=DEVICE))[1]
        cache["k"][:, i:i + 1, :len(p)] = pre["k"]
        cache["v"][:, i:i + 1, :len(p)] = pre["v"]
    cache["length"] = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    steps["dense"] = T.decode_step(params, cfg, tok[:b], cache)[0]
    return steps


@contextlib.contextmanager
def _planted_bf16(torch, module, name: str, tp: int, shard: int = 1):
    """A planted fault: while the block runs, shard ``shard``'s output of
    the kernel wrapper ``module.name`` is rounded to bf16. A sharded layer
    calls its shards in order, so that is every tp-th call from the
    ``shard``-th."""
    orig = getattr(module, name)
    calls = [0]

    def planted(*args, **kw):
        out = orig(*args, **kw)
        calls[0] += 1
        if (calls[0] - 1) % tp != shard:
            return out
        first = out[0] if isinstance(out, tuple) else out
        bad = first.to(torch.bfloat16).to(first.dtype)
        return (bad, *out[1:]) if isinstance(out, tuple) else bad

    setattr(module, name, planted)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _tp_logits(torch, cfg, params, prompts) -> dict:
    """fp32, on one prefilled state: the first B=4 decode step paged at TP 1
    against the dense decode_step, and paged at TP 2 / 4 against TP 1; the
    sharded prefill of the 1100-token prompt (K4 per shard) at TP 2 / 4
    against the unsharded one. Each holds max |delta logit| within its
    limit, and the planted fault at TP 2 must read above it."""
    import repro_torch.kernels.flash_prefill as k4
    import repro_torch.kernels.paged_attention as k3
    from repro_torch.distributed import tp as tp_mod
    from repro_torch.models import transformer as T

    out = {}

    def hold(name, got, want, limit, planted=False):
        delta = float((got - want).abs().max())
        out[name] = dict(max_abs_delta=delta, limit=limit,
                         bit_identical=bool(torch.equal(got, want)),
                         argmax_equal=bool(torch.equal(got.argmax(-1), want.argmax(-1))))
        if planted:
            check(delta > limit, f"e2e_moe_tp: the planted fault {name} reads {delta}, "
                                 f"within the limit {limit}")
        else:
            check(delta <= limit, f"e2e_moe_tp: {name} logits off by {delta} (limit {limit})")

    steps = _first_steps(torch, cfg, params, prompts, (1, 2, 4))
    hold("tp1_paged_vs_dense_step", steps[1], steps["dense"], MOE_STEP_TOL)
    for tp in (2, 4):
        hold(f"tp{tp}_first_decode_step", steps[tp], steps[1], MOE_STEP_TOL)
    kv, bt, tok, ln = _paged_state(torch, cfg, params, prompts, 2)
    with _planted_bf16(torch, k3, "paged_decode_attention", 2):
        bad = _step_fn(torch, cfg, params, kv, bt, tok, ln, 2)()[:len(prompts)]
    del kv
    hold("planted_k3_bf16_tp2_step", bad, steps[1], MOE_STEP_TOL, planted=True)
    p = torch.tensor([prompts[2]], dtype=torch.int32, device=DEVICE)
    want = T.prefill(params, cfg, p)[0]
    for tp in (2, 4):
        got = tp_mod.sharded_prefill(tp_mod.shard_params(params, cfg, tp), cfg, p)[0]
        hold(f"tp{tp}_prefill_1100", got, want, MOE_PREFILL_TOL)
    with _planted_bf16(torch, k4, "flash_prefill_op", 2):
        bad = tp_mod.sharded_prefill(tp_mod.shard_params(params, cfg, 2), cfg, p)[0]
    hold("planted_k4_bf16_tp2_prefill_1100", bad, want, MOE_PREFILL_TOL, planted=True)
    return out


def _moe_step_timing(torch, cfg, params, prompts, tp, peaks) -> dict:
    """The bf16 decode step at B=4 on a pool of ``tp`` shards: median wall of
    10 synchronized steps, device time by kernel over 3 profiled steps, K3's
    share, and the MoE FFNs' device time (the 24 layers' dense-dispatch
    experts on the step's shape, profiled alone) against the floor of
    reading every expert weight once."""
    from repro_torch.distributed import tp as tp_mod
    from repro_torch.models import transformer as T

    kv, bt, tok, ln = _paged_state(torch, cfg, params, prompts, tp)
    out, by_kernel = _step_profile(torch, _step_fn(torch, cfg, params, kv, bt, tok, ln, tp))
    total = sum(by_kernel.values())
    x = torch.randn((bt.shape[0], 1, cfg.d_model), device=DEVICE).to(cfg.dtype)
    if tp == 1:
        lps = [T.layer_params(params, i) for i in range(cfg.num_layers)]
        ffn = lambda: [T._ffn(lp, x, cfg) for lp in lps]  # noqa: E731
    else:
        shards = tp_mod.shard_params(params, cfg, tp)
        merged = tp_mod.merged_combine(shards, cfg)
        layers = [tp_mod._layer(shards, merged, i) for i in range(cfg.num_layers)]
        ffn = lambda: [tp_mod._sharded_ffn(lps, mi, x, cfg) for lps, mi in layers]  # noqa: E731
    ffn()
    sync(torch)
    moe_us = sum(_profiled(torch, ffn)[0].values())
    weight_bytes = (cfg.num_layers * 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
                    * cfg.dtype.itemsize)
    floor_ms, _ = bound_ms(weight_bytes, 0, peaks, "bf16")
    del kv
    return dict(out, tp=tp, step_batch=len(prompts), k3_launches_per_step=cfg.num_layers * tp,
                moe_ffn_device_ms=moe_us / 3e3, moe_share=moe_us / total if total else None,
                expert_weight_bytes=weight_bytes, expert_weight_read_floor_ms=floor_ms)


def phase_e2e_moe_tp(torch, env) -> dict:
    """granite-moe-1b-a400m at full width and depth, served 1P+1D at TP 1,
    2 -> 2 and 2 -> 4 in fp32 (the token gate) and at TP 1 and 2 -> 4 in its
    bf16 (the timing run). Returns the fp32 2 -> 4 run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import sharded_transfer_calls
    from repro_torch.kernels.kv_gather import ops
    from repro_torch.models import transformer as T

    tag = "e2e_moe_tp"
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype=torch.float32)
    prompts = _prompts(cfg, PROMPT_LENS, SEED)
    params = _moe_params(torch, cfg)
    L = cfg.num_layers
    mono = _monolithic(torch, cfg, params, prompts)
    distinct = [len(set(s)) for s in mono]
    check(min(distinct) >= MOE_MIN_DISTINCT,
          f"{tag} fp32: the monolithic streams hold {distinct} distinct tokens of "
          f"{MOE_NEW_TOKENS}: a token gate on them tests little")
    data = dict(model=cfg.name, layers=L, d_model=cfg.d_model, experts=cfg.num_experts,
                top_k=cfg.top_k, heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
                params=cfg.num_params(), prompt_lens=PROMPT_LENS, new_tokens=MOE_NEW_TOKENS,
                blocks=MOE_BLOCKS, attn_scale=MOE_ATTN_SCALE, distinct_tokens=distinct,
                fp32={})
    fine_counts = None
    for tpd in MOE_TP:
        key = f"{tpd[0]}->{tpd[1]}"
        client, handles, counts, wall = _moe_serve(torch, cfg, params, prompts, tpd, 2048,
                                                   records=True)
        s = client.stats()
        outs = [list(map(int, h.request.output_tokens)) for h in handles]
        xfers = [t for t in client.cluster.transfers if t.kind == "kv"]
        moved = sum(t.num_dispatches for t in xfers)
        expected = sharded_transfer_calls(tpd[0], tpd[1])
        sharded = tpd[0] > 1 or tpd[1] > 1
        check(outs == mono, f"{tag} fp32 TP {key}: tokens differ from monolithic")
        check(s["finished"] == len(prompts), f"{tag} fp32 TP {key}: {s['finished']} finished")
        check(len(xfers) == len(prompts) and all(t.status == "ok" and t.retries == 0
                                                 for t in xfers),
              f"{tag} fp32 TP {key}: transfers {[(t.status, t.retries) for t in xfers]} "
              "(a failed device verify retries)")
        check(s["mean_transfer_dispatches"] == expected,
              f"{tag} fp32 TP {key}: {s['mean_transfer_dispatches']} dispatches a transfer "
              f"!= {expected}")
        check(s["decode_dispatches"] == s["decode_steps"] > 0,
              f"{tag} fp32 TP {key}: decode dispatches {s['decode_dispatches']} != steps")
        check(counts["paged_decode_attention"] == s["decode_steps"] * L * tpd[1],
              f"{tag} fp32 TP {key}: {counts['paged_decode_attention']} K3 launches for "
              f"{s['decode_steps']} steps of {L} layers x {tpd[1]} shards")
        k1_moves = counts["kv_transfer_fine"] if sharded else counts["kv_transfer"] - \
            s["decode_steps"]
        check(k1_moves == moved and counts["kv_transfer"] >= s["decode_steps"] * tpd[1],
              f"{tag} fp32 TP {key}: K1 launches {counts} for {moved} transfer dispatches")
        check(counts["flash_prefill"] > 0 and counts["kv_scatter"] > 0,
              f"{tag} fp32 TP {key}: K4 / K5b not launched: {counts}")
        check(s["leaked_blocks"] == 0.0 and client.cluster.audit_blocks() == 0,
              f"{tag} fp32 TP {key}: leaked blocks")
        data["fp32"][key] = dict(
            serve_s=wall, launches=counts, transfers=s["transfers"],
            mean_transfer_dispatches=s["mean_transfer_dispatches"],
            shard_dispatches=s["shard_dispatches"], sharded_nodes=s["sharded_nodes"],
            decode_steps=s["decode_steps"], tokens_equal_monolithic=True,
            ttft_wall_s=[h.request.first_token_wall - h.request.arrival_wall for h in handles],
            transfer_wall_s=[h.request.transfer_end_wall - h.request.transfer_start_wall
                             for h in handles])
        if tpd == MOE_TP[-1]:
            fine_counts = counts
        del client, handles
        gc.collect()
    data["tp_logits_fp32"] = _tp_logits(torch, cfg, params, prompts)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(MOE_ARCH)                      # its own bf16
    params = _moe_params(torch, cfg)
    first = [int(torch.argmax(T.prefill(params, cfg, torch.tensor(
        [p], dtype=torch.int32, device=DEVICE))[0][0])) for p in prompts]
    data["bf16"] = {}
    for tpd in MOE_TIMED_TP:
        key = f"{tpd[0]}->{tpd[1]}"
        client, handles, counts, wall = _moe_serve(torch, cfg, params, prompts, tpd, 4096)
        s = client.stats()
        outs = [list(map(int, h.request.output_tokens)) for h in handles]
        check(s["finished"] == len(prompts) and all(len(o) == MOE_NEW_TOKENS for o in outs),
              f"{tag} bf16 TP {key}: {s['finished']} finished")
        check([o[0] for o in outs] == first,
              f"{tag} bf16 TP {key}: first tokens differ from monolithic prefill")
        check(s["leaked_blocks"] == 0.0, f"{tag} bf16 TP {key}: leaked blocks")
        data["bf16"][key] = dict(
            serve_s=wall, launches=counts,
            mean_transfer_dispatches=s["mean_transfer_dispatches"],
            decode_steps=s["decode_steps"], first_tokens_equal=True,
            timing=[{"prompt_len": r.prompt_len,
                     "ttft_wall_s": r.first_token_wall - r.arrival_wall,
                     "transfer_wall_s": r.transfer_end_wall - r.transfer_start_wall}
                    for r in (h.request for h in handles)],
            step=_moe_step_timing(torch, cfg, params, prompts, tpd[1], env["peaks"]))
        del client, handles
        gc.collect()
    # the 2 -> 4 run again in turns, with every K1 launch one block a row
    # (the fine rows' design before the small-row kernel) and as shipped
    walls = {"block_a_row": [], "small_rows": []}
    for name in ("block_a_row", "small_rows", "small_rows", "block_a_row"):
        with (_patched(ops, "k1_design", _block_a_row) if name == "block_a_row"
              else contextlib.nullcontext()):
            client, handles, _, _ = _moe_serve(torch, cfg, params, prompts, MOE_TP[-1], 4096)
        check([int(h.request.output_tokens[0]) for h in handles] == first,
              f"{tag} bf16 TP 2->4 ({name}): first tokens differ")
        walls[name].append([h.request.transfer_end_wall - h.request.transfer_start_wall
                            for h in handles])
        del client, handles
        gc.collect()
    data["bf16_transfer_wall_s_2->4_in_turns"] = walls
    data["bf16_cold_prefill_profile"] = profile_cold_prefill(torch, cfg, params, prompts[-1])
    check(data["bf16_cold_prefill_profile"]["k4_ms"] > 0,
          f"{tag}: the cold prefill of {PROMPT_LENS[-1]} tokens launched no K4")
    data["seconds"] = time.perf_counter() - t_phase
    emit(tag, **data)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return fine_counts


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
# e2e_state: the state families and the state transfer path
# ---------------------------------------------------------------------------
# arch -> (prompt lengths, new tokens, cache leaves = transfer calls)
STATE_RUNS = {"mamba2-370m": ([200, 640, 1100, 1500], 16, 5),
              "recurrentgemma-2b": ([640, 1500, 3000], 8, 11)}
STATE_BLOCKS = 512                     # admission budget only: no pool
STATE_BATCH_TOKENS = 4096              # whole-prompt admission of 3000 tokens
# fp32 consistency of two algorithms on one input: a decode step from the
# prefilled state against the prefill of the prompt plus the tokens so far
# (CONSISTENCY_STEPS steps), and mamba2's prefill at ssm_chunk 256 against
# CHUNK_ALT. Held to STATE_LIMIT x max(1, max |logit|): the sound runs read
# up to ~5e-5 on the H100 (the SSD's in-chunk cumsum of log a in fp32 sets
# that), and each check's planted fault (_plant_*, _chunked_h_bf16) must
# read above it, else the gate could not see a real fault
# (tools/state_conditioning_probe.py reads both).
CONSISTENCY_LEN = {"mamba2-370m": 1100, "recurrentgemma-2b": 3000}
CONSISTENCY_STEPS = 6
CHUNK_ALT = 100
# 10 tokens past CHUNK_ALT's last boundary: mamba2's state forgets fast (the
# init's A_log spans log 1..16, so even the slowest head decays by exp(-dt)
# a token), and a fault at a boundary far behind the last token never
# reaches its logits
CHUNK_CHECK_LEN = 1110
STATE_LIMIT = 5e-4
# griffin's and seamless's random attention is chaotic at the init's scale
# (as granite's, e2e_moe_tp): dense_init reads the heads axis of wq / wk
# (d, H, hd) as their fan-in, so scores are d / H = 256x (griffin) and 64x
# (seamless) too large and an fp32 summation-order difference flips which
# key wins (tools/state_conditioning_probe.py: decode vs prefill far above
# STATE_LIMIT at the init's scale).
# e2e_state scales wq and wk (and the cross-attention's) by sqrt(H / d),
# the fan-in dense_init meant; wv stays (at fan-in scale the streams
# collapse to one token).
STATE_TEMPERED = ("hybrid", "encdec")
# seamless-m4t-large-v2 at the model level: encoder frames, a decoder
# prompt, greedy steps from a cache padded into init_cache(max_len)
SEAMLESS = "seamless-m4t-large-v2"
SEAMLESS_FRAMES = [600, 1500, 4096]
SEAMLESS_K4_LENS = [1500, 4096]        # its K4 shapes in the kernels phase
SEAMLESS_PROMPT = 32
SEAMLESS_STEPS = 8
SEAMLESS_CHECK_FRAMES = 1500


def _temper_attention(torch, cfg, params) -> None:
    """Scale every attention's wq and wk by sqrt(H / d) in place (see
    STATE_TEMPERED)."""
    f = (cfg.num_heads / cfg.d_model) ** 0.5
    stacks = ([params["groups"]["attn"]] if cfg.family == "hybrid"
              else [params["encoder"], params["decoder"]])
    for st in stacks:
        for name in ("wq", "wk", "x_wq", "x_wk"):
            if name in st:
                st[name].mul_(f)


def _state_generate(torch, model, params, batch, new, pad=None) -> list:
    """The port's monolithic generation: prefill, then the decode loop on
    the prefill's state (``pad`` widens an enc-dec cache first)."""
    logits, cache = model.prefill(params, batch)
    if pad is not None:
        cache = pad(cache)
    out = [int(torch.argmax(logits[0]))]
    while len(out) < new:
        tok = torch.tensor(out[-1:], dtype=torch.int32, device=DEVICE)
        logits, cache = model.decode(params, tok, cache)
        check(bool(torch.isfinite(logits).all()), "non-finite decode logits")
        out.append(int(torch.argmax(logits[0])))
    return out


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _decode_vs_prefill(torch, model, params, batch_of, prompt, steps, plant=None,
                       pad=None) -> list:
    """Each decode step's logits from the prefilled state against the
    prefill of the prompt plus the tokens so far (fp32); ``plant(cache)``
    damages the state before each step, ``pad`` widens an enc-dec cache.
    Returns the relative errors."""
    logits, cache = model.prefill(params, batch_of(prompt))
    if pad is not None:
        cache = pad(cache)
    seq = list(prompt) + [int(torch.argmax(logits[0]))]
    errs = []
    for _ in range(steps):
        if plant is not None:
            cache = plant(cache)
        tok = torch.tensor(seq[-1:], dtype=torch.int32, device=DEVICE)
        ld, cache = model.decode(params, tok, cache)
        lp, _ = model.prefill(params, batch_of(seq))
        errs.append(_rel_err(ld, lp))
        seq.append(int(torch.argmax(lp[0])))
    return errs


def _plant_ssm_h(torch, cache):
    """Planted: mamba2's fp32 h rounded to bf16 (a state kept at the
    config's dtype)."""
    return dict(cache, h=cache["h"].to(torch.bfloat16).float())


def _plant_ring_slot(torch, cache):
    """Planted: the newest ring slot (the last token's K/V) of every
    attention layer zeroed, as a ring written one slot off would leave it."""
    w = cache["g_k"].shape[2]
    slot = (int(cache["length"][0]) - 1) % w
    gk, gv = cache["g_k"].clone(), cache["g_v"].clone()
    gk[:, :, slot] = 0
    gv[:, :, slot] = 0
    return dict(cache, g_k=gk, g_v=gv)


def _plant_self_kv(torch, cache):
    """Planted: the decoder's self K/V of its first position zeroed."""
    k, v = cache["k"].clone(), cache["v"].clone()
    k[:, :, 0] = 0
    v[:, :, 0] = 0
    return dict(cache, k=k, v=v)


def _chunked_h_bf16(torch, orig):
    """Planted into mamba2's SSD: h rounded to bf16 between chunks (the
    original scan run one chunk at a time)."""
    def planted(log_a, Bm, Cm, xdt, h0, chunk):
        ys, h = [], h0
        for c0 in range(0, log_a.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            y, h = orig(log_a[:, sl], Bm[:, sl], Cm[:, sl], xdt[:, sl], h, chunk)
            h = h.to(torch.bfloat16).float()
            ys.append(y)
        return torch.cat(ys, dim=1), h
    return planted


@contextlib.contextmanager
def _patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def _hold(tag, name, errs, planted) -> dict:
    """A consistency check: the sound errors within STATE_LIMIT, the planted
    fault's above it."""
    sound, bad = max(errs), max(planted)
    check(sound <= STATE_LIMIT, f"{tag}: {name} off by {sound} > {STATE_LIMIT}")
    check(bad > STATE_LIMIT, f"{tag}: the planted fault of {name} reads {bad}, within "
                             f"the limit {STATE_LIMIT}: the gate cannot see it")
    return {"max_rel_err": sound, "per_step": errs, "planted_max_rel_err": bad,
            "limit": STATE_LIMIT}


def _scan_profile(torch, module, name, run) -> dict:
    """The device time of every call ``run()`` makes to ``module.name`` (the
    SSD chunk loop / the RG-LRU's log-depth scan): the calls' inputs are
    recorded during one run, then replayed alone under the profiler."""
    calls, orig = [], getattr(module, name)

    def record(*args):
        calls.append(args)
        return orig(*args)

    with _patched(module, name, record):
        run()
    sync(torch)
    by_kernel, wall = _profiled(torch, lambda: [orig(*a) for a in calls], n=1)
    out = dict(calls=len(calls), device_ms=sum(by_kernel.values()) / 1e3,
               replay_wall_ms=wall * 1e3)
    del calls
    return out


def _state_timing(torch, model, params, prompts, handles, scan) -> dict:
    """bf16: the run's TTFT and handoff walls with the state bytes (beside
    qwen3-1.7b's K/V at the same length, reckoned), one decode step's wall
    and device time, and one cold prefill's device split with the scan's
    own device time."""
    from repro_torch.configs import get_config

    kv_tok = get_config(ARCH).kv_bytes_per_token()
    per_req = []
    for h in handles:
        r = h.request
        per_req.append({"prompt_len": r.prompt_len,
                        "ttft_wall_s": r.first_token_wall - r.arrival_wall,
                        "handoff_wall_ms": (r.transfer_end_wall - r.transfer_start_wall) * 1e3,
                        "qwen3_kv_bytes_same_len": kv_tok * r.prompt_len})
    longest = max(prompts, key=len)
    tok = torch.tensor([longest], dtype=torch.int32, device=DEVICE)
    _, cache = model.prefill(params, {"tokens": tok})
    step_tok = torch.tensor([1], dtype=torch.int32, device=DEVICE)
    step = lambda: model.decode(params, step_tok, cache)   # noqa: E731  (functional)
    for _ in range(3):
        step()
    sync(torch)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        sync(torch)
        walls.append(time.perf_counter() - t0)
    by_kernel, wall = _profiled(torch, step)
    total = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:6]
    prefill = _profile_split(torch, lambda: model.prefill(params, {"tokens": tok}))
    scan_prof = _scan_profile(torch, *scan, lambda: model.prefill(params, {"tokens": tok}))
    scan_prof["share_of_prefill_device"] = scan_prof["device_ms"] / prefill["device_ms"]
    return {"requests": per_req, "step_prompt_len": len(longest),
            "step_wall_ms": statistics.median(walls) * 1e3, "step_device_ms": total / 3e3,
            "step_device_busy_share": (total / 1e6) / wall if wall else None,
            "step_top_kernels_ms": [(k[:80], v / 3e3) for k, v in top],
            "cold_prefill": dict(prompt_len=len(longest), **prefill), "scan": scan_prof}


def _serve_state(torch, cfg, params, prompts, new):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams

    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1, num_blocks=STATE_BLOCKS,
                          max_batch_tokens=STATE_BATCH_TOKENS, device=DEVICE)
    sync(torch)
    reset_launch_counts()
    t0 = time.perf_counter()
    handles = [client.submit(p, SamplingParams(max_new_tokens=new)) for p in prompts]
    client.drain(max_cycles=500)
    sync(torch)
    return client, handles, launch_counts(), time.perf_counter() - t0


def _state_family(torch, arch) -> dict:
    """One state-family arch at full width and depth: served 1P+1D in bf16
    and fp32 against monolithic generation, the fp32 consistency checks,
    the bf16 timing."""
    from repro_torch.configs import get_config
    from repro_torch.models import griffin as G
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.api import get_model

    lengths, new, leaves = STATE_RUNS[arch]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = f"e2e_state {arch} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
        cfg = dataclasses.replace(get_config(arch), dtype=dtype)
        model = get_model(cfg)
        params = model.init(SEED, DEVICE)
        if cfg.family in STATE_TEMPERED:
            _temper_attention(torch, cfg, params)
        prompts = _prompts(cfg, lengths, SEED)
        torch.cuda.reset_peak_memory_stats()
        client, handles, counts, serve_s = _serve_state(torch, cfg, params, prompts, new)
        s = client.stats()
        xfers = [t for t in client.cluster.transfers if t.kind == "kv"]
        outs = [h.request.output_tokens for h in handles]
        mono = [_state_generate(torch, model, params, {"tokens": torch.tensor(
            [p], dtype=torch.int32, device=DEVICE)}, new) for p in prompts]
        check(s["finished"] == len(prompts), f"{tag}: {s['finished']} finished")
        check(outs == mono, f"{tag}: served tokens differ from monolithic generation")
        check(len(xfers) == len(prompts) and all(
            (t.status, t.schedule, t.num_calls, t.num_dispatches) == ("ok", "state", leaves, 1)
            for t in xfers), f"{tag}: transfers {[(t.status, t.schedule, t.num_calls, t.num_dispatches) for t in xfers]}")
        check(s["decode_dispatches"] >= s["decode_steps"] > 0, f"{tag}: decode accounting {s}")
        check(all(not e.states for e in client.cluster.engines.values()),
              f"{tag}: states left behind")
        check(s["leaked_blocks"] == 0.0, f"{tag}: leaked blocks")
        data = dict(model=cfg.name, dtype=str(dtype), layers=cfg.num_layers,
                    d_model=cfg.d_model, prompt_lens=lengths, new_tokens=new,
                    serve_s=serve_s, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                    state_bytes=[t.num_bytes for t in xfers], transfer_calls=leaves,
                    decode_steps=s["decode_steps"], decode_dispatches=s["decode_dispatches"],
                    distinct_tokens=[len(set(o)) for o in outs], launches=counts)
        if dtype == torch.bfloat16:
            scan = (M2, "_ssd_chunked") if cfg.family == "ssm" else (G, "linear_scan")
            data.update(_state_timing(torch, model, params, prompts, handles, scan))
        else:
            prompt = _prompts(cfg, [CONSISTENCY_LEN[arch]], SEED + 1)[0]
            batch_of = lambda seq: {"tokens": torch.tensor(   # noqa: E731
                [seq], dtype=torch.int32, device=DEVICE)}
            plant = _plant_ssm_h if cfg.family == "ssm" else _plant_ring_slot
            data["decode_vs_prefill"] = _hold(
                tag, "decode vs prefill",
                _decode_vs_prefill(torch, model, params, batch_of, prompt, CONSISTENCY_STEPS),
                _decode_vs_prefill(torch, model, params, batch_of, prompt, CONSISTENCY_STEPS,
                                   plant=lambda c: plant(torch, c)))
            if cfg.family == "ssm":
                alt = get_model(dataclasses.replace(cfg, ssm_chunk=CHUNK_ALT))
                prompt = _prompts(cfg, [CHUNK_CHECK_LEN], SEED + 1)[0]
                want, _ = model.prefill(params, batch_of(prompt))
                got, _ = alt.prefill(params, batch_of(prompt))
                with _patched(M2, "_ssd_chunked", _chunked_h_bf16(torch, M2._ssd_chunked)):
                    bad, _ = alt.prefill(params, batch_of(prompt))
                data["chunk_256_vs_100"] = _hold(tag, "chunk 256 vs 100", [_rel_err(got, want)],
                                                 [_rel_err(bad, want)])
        emit("e2e_state", arch=arch, **data)
        out[str(dtype)] = data
        del params, client, handles, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _seamless(torch) -> tuple:
    """seamless-m4t-large-v2 at the model level (bf16): encode, prefill and
    greedy decode from a padded cache at each frame count, K4 non-causal
    launches counted per encoder pass; then the fp32 consistency check.
    Returns (bf16 counts, fp32 counts, data)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import encdec as E
    from repro_torch.models.api import get_model

    data = {}
    counts = {}
    for dtype in (torch.bfloat16, torch.float32):
        key = "bf16" if dtype == torch.bfloat16 else "fp32"
        tag = f"e2e_state {SEAMLESS} {key}"
        cfg = dataclasses.replace(get_config(SEAMLESS), dtype=dtype)
        model = get_model(cfg)
        params = model.init(SEED, DEVICE)
        _temper_attention(torch, cfg, params)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED)
        prompt = _prompts(cfg, [SEAMLESS_PROMPT], SEED)[0]

        def batch(frames, seq):
            return {"frames": frames, "tokens": torch.tensor([seq], dtype=torch.int32,
                                                             device=DEVICE)}

        def pad(frames):
            def fn(cache):
                c = E.init_cache(cfg, 1, SEAMLESS_PROMPT + SEAMLESS_STEPS + 1,
                                 frames.shape[1], device=DEVICE)
                n = cache["k"].shape[2]
                c["k"][:, :, :n] = cache["k"]
                c["v"][:, :, :n] = cache["v"]
                c.update(cross_k=cache["cross_k"], cross_v=cache["cross_v"],
                         length=cache["length"].clone())
                return c
            return fn

        if dtype == torch.bfloat16:
            runs = []
            sync(torch)
            reset_launch_counts()
            for n in SEAMLESS_FRAMES:
                frames = torch.randn((1, n, cfg.d_model), generator=gen, device=DEVICE)
                before = launch_counts()["flash_prefill_noncausal"]
                toks = _state_generate(torch, model, params, batch(frames, prompt),
                                       SEAMLESS_STEPS, pad=pad(frames))
                sync(torch)
                k4 = launch_counts()["flash_prefill_noncausal"] - before
                want = cfg.num_encoder_layers if n > cfg.flash_threshold else 0
                check(k4 == want, f"{tag}: {k4} K4 non-causal launches for {n} frames, "
                                  f"want {want}")
                runs.append({"frames": n, "k4_noncausal_launches": k4, "tokens": toks,
                             "distinct_tokens": len(set(toks))})
            counts[key] = launch_counts()
            frames = torch.randn((1, max(SEAMLESS_FRAMES), cfg.d_model), generator=gen,
                                 device=DEVICE)
            enc = _profile_split(torch, lambda: E.encode(params, cfg, frames))
            data[key] = {"runs": runs, "launches": counts[key],
                         "encoder_profile": dict(frames=frames.shape[1], **enc)}
        else:
            frames = torch.randn((1, SEAMLESS_CHECK_FRAMES, cfg.d_model), generator=gen,
                                 device=DEVICE)
            batch_of = lambda seq: batch(frames, seq)   # noqa: E731
            sync(torch)
            reset_launch_counts()
            sound = _decode_vs_prefill(torch, model, params, batch_of, prompt,
                                       SEAMLESS_STEPS, pad=pad(frames))
            sync(torch)
            counts[key] = launch_counts()
            check(counts[key]["flash_prefill_noncausal"] ==
                  cfg.num_encoder_layers * (SEAMLESS_STEPS + 1),
                  f"{tag}: K4 non-causal launches {counts[key]}")
            bad = _decode_vs_prefill(torch, model, params, batch_of, prompt, SEAMLESS_STEPS,
                                     plant=lambda c: _plant_self_kv(torch, c),
                                     pad=pad(frames))
            data[key] = {"frames": SEAMLESS_CHECK_FRAMES, "launches": counts[key],
                         "decode_vs_prefill": _hold(tag, "decode vs prefill", sound, bad)}
        emit("e2e_state", arch=SEAMLESS, dtype=str(dtype), **data[key])
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    return counts, data


def phase_e2e_state(torch, env) -> tuple:
    """Phase 10: mamba2-370m and recurrentgemma-2b served P->D through the
    state path, seamless-m4t-large-v2's encoder on K4 non-causal. One model
    on the card at a time. Returns (seamless bf16 counts, fp32 counts)."""
    t0 = time.perf_counter()
    for arch in STATE_RUNS:
        _state_family(torch, arch)
    counts, _ = _seamless(torch)
    emit("e2e_state", done=True, seconds=time.perf_counter() - t0)
    return counts["bf16"], counts["fp32"]

# ---------------------------------------------------------------------------
# train: the training path (loss and forward_train, AdamW over fp32 masters,
# the train step, the train-state checkpoint, launch/train.py's loop)
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S = 2, 1024             # train_main: one fixed copy-task batch
TRAIN_STEPS, TRAIN_SAVE_AT = 8, 4
TRAIN_LR = 1e-4                        # warm-up of 1 step
TRAIN_RESUME_REL = 1e-3                # steps 5-8 resumed vs uninterrupted
FLASH_S = 2048                         # train_flash: above flash_threshold (1024)
FLASH_REMAT_LAYERS = 4
REMAT_LOSS_REL, REMAT_GNORM_REL = 1e-6, 1e-4
# train_parity: one fp32 step on the card and on the CPU from the same
# weights, each family at full width: (arch, layers, batch, tokens, config
# overrides). seamless: 2 + 2 layers, 256 encoder frames, 32 decoder tokens.
PARITY = (("qwen3-1.7b", 2, 1, 256, {}),
          ("granite-moe-1b-a400m", 2, 1, 256, {"moe_dispatch": "dense"}),
          ("mamba2-370m", 2, 1, 300, {}),
          ("recurrentgemma-2b", 5, 1, 256, {}),
          ("seamless-m4t-large-v2", 2, 1, 32, {"num_encoder_layers": 2}))
PARITY_FRAMES = 256
# Adam's first step moves an element by lr * g / (|g| + eps): at the default
# eps = 1e-8 that is lr * sign(g), and an element whose gradient sits at the
# fp32 noise floor flips sign between the card and the CPU (a 2 lr step).
# eps = 1e-3 makes the update of a small gradient lr / eps * g = 0.1 g, so
# the master gate (1e-6 absolute) reads the gradient and the update rule,
# while the update itself reaches lr = 1e-4.
PARITY_OPT = dict(lr=1e-4, eps=1e-3, warmup_steps=1)
PARITY_LOSS_REL, PARITY_GRAD_REL, PARITY_MASTER_ABS = 1e-5, 1e-3, 1e-6
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"
# ops whose kernels make each part of a train step's device time: a kernel
# belongs to the first part one of whose ops launched it or encloses that
# op (forward ops and their autograd nodes); other GEMM kernels are "gemm",
# the remaining kernels "rest". "optimizer" is a record_function range
# around OPT.apply_updates.
TRAIN_PARTS = (
    ("optimizer", {"optimizer"}),
    ("attention", {"aten::bmm", "aten::_softmax", "aten::_softmax_backward_data",
                   "aten::masked_fill", "BmmBackward0", "SoftmaxBackward0",
                   "MaskedFillBackward0"}),
    ("cross_entropy", {"aten::logsumexp", "aten::gather", "LogsumexpBackward0",
                       "GatherBackward0"}))
GEMM_FRAGS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")


def _leaf_digest(torch, t) -> tuple:
    """A train-state leaf's dtype, shape and device, and two sums over its
    raw words (the first plain, the second with each word weighted by an
    odd number from its position): one changed word changes the second sum,
    and two leaves that are bit for bit the same give the same digest."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}
    words = t.detach().reshape(-1)
    words = words.view(ints[t.dtype]) if t.dtype in ints else words
    plain = weighted = 0
    chunk = 1 << 24
    for start in range(0, words.numel(), chunk):
        w = words[start:start + chunk].to(torch.int64)
        pos = torch.arange(start, start + w.numel(), device=w.device, dtype=torch.int64)
        plain += int(w.sum())
        weighted += int((w * (2 * (pos % 1_000_003) + 1)).sum())
    return str(t.dtype), tuple(t.shape), str(t.device), plain, weighted


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _train_step_split(torch, step_fn, state, batch) -> tuple:
    """One train step under torch.profiler: its wall and its device time by
    part (TRAIN_PARTS), with the top kernels. Returns (state, summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.training import optimizer as OPT

    orig = OPT.apply_updates

    def marked(*a, **kw):
        with record_function("optimizer"):
            return orig(*a, **kw)

    with _patched(OPT, "apply_updates", marked):
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch)
            sync(torch)
            wall = time.perf_counter() - t0
    parts = dict.fromkeys(("gemm", "attention", "cross_entropy", "optimizer", "rest"), 0.0)
    for ev in prof.events():
        kernels = getattr(ev, "kernels", None) or []
        if not kernels:
            continue
        names, e = [], ev
        while e is not None:
            names.append(e.name)
            e = e.cpu_parent
        part = next((p for p, ops in TRAIN_PARTS if any(n in ops for n in names)), None)
        for k in kernels:
            p = part or ("gemm" if any(f in k.name.lower() for f in GEMM_FRAGS) else "rest")
            parts[p] += k.duration
    by_kernel = _device_by_kernel(prof)
    total = sum(by_kernel.values())
    check(total > 0, "train step: the profiler saw no device time")
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:8]
    return state, dict(profiled_wall_ms=wall * 1e3, device_ms=total / 1e3,
                       split_ms={k: v / 1e3 for k, v in parts.items()},
                       split_covers=sum(parts.values()) / total,
                       device_busy_share=(total / 1e6) / wall,
                       top_kernels_ms=[(k[:80], v / 1e3) for k, v in top])


def _train_main(torch, env) -> None:
    """Full-width, full-depth qwen3-1.7b, bf16 over fp32 masters, B=2,
    S=1024: 8 steps of launch/train.py's loop on the copy task, saved at
    step 4, loaded into an abstract template on the card, resumed."""
    import numpy as np
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.distributed import steps as ST
    from repro_torch.launch import train as LT
    from repro_torch.models.api import get_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import checkpoint as CK
    from repro_torch.training import optimizer as OPT

    cfg = get_config(ARCH)
    model = get_model(cfg)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    state = OPT.init_state(model.init(SEED, DEVICE))
    step_fn, _ = ST.make_train_step(model, opt_cfg=OPT.AdamWConfig(lr=TRAIN_LR,
                                                                  warmup_steps=1))
    toks = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S))).to(DEVICE)
    batch = {"tokens": toks, "labels": toks}          # the copy task
    walls, log = [], []

    def timed(st, b):
        sync(torch)
        t0 = time.perf_counter()
        out = step_fn(st, b)
        sync(torch)
        walls.append(time.perf_counter() - t0)
        return out

    state, losses = LT.train_loop(state, timed, lambda: batch, 0, TRAIN_SAVE_AT, log=log.append)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = CK.save_train_state(state, TRAIN_SAVE_AT, str(TRAIN_CKPT_DIR))
    save_s = time.perf_counter() - t0
    ckpt_bytes = pathlib.Path(path).stat().st_size
    # the saved state's digest, leaf by leaf: the one load below is held to
    # it bit for bit, then resumes (the state itself runs on uninterrupted)
    saved_digests = [_leaf_digest(torch, leaf) for leaf in tree_leaves(state)]
    state, tail = LT.train_loop(state, timed, lambda: batch, TRAIN_SAVE_AT,
                                TRAIN_STEPS - TRAIN_SAVE_AT, log=log.append)
    losses += tail
    peak = torch.cuda.max_memory_allocated()
    check(int(state["step"]) == TRAIN_STEPS, f"train_main: step {int(state['step'])}")
    check(all(math.isfinite(x) for x in losses), f"train_main: losses {losses}")
    check(losses[-1] < losses[0], f"train_main: the loss did not fall: {losses}")
    state, split = _train_step_split(torch, step_fn, state, batch)
    del state
    _free(torch)
    t0 = time.perf_counter()
    resumed = CK.load_train_state(ST.abstract_train_state(model), path, device=DEVICE)
    sync(torch)
    load_s = time.perf_counter() - t0
    loaded_digests = [_leaf_digest(torch, leaf) for leaf in tree_leaves(resumed)]
    check(loaded_digests == saved_digests,
          "train_main: the loaded train state differs from the saved one")
    resumed, losses_resumed = LT.train_loop(resumed, step_fn, lambda: batch, TRAIN_SAVE_AT,
                                            TRAIN_STEPS - TRAIN_SAVE_AT, log=log.append)
    check(int(resumed["step"]) == TRAIN_STEPS, "train_main: the resumed run's step")
    del resumed
    _free(torch)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    spread = [abs(a - b) / abs(b) for a, b in zip(losses_resumed, losses[TRAIN_SAVE_AT:])]
    check(max(spread) <= TRAIN_RESUME_REL,
          f"train_main: resumed losses {losses_resumed} vs {losses[TRAIN_SAVE_AT:]}")
    n_params = cfg.num_params()
    active = cfg.active_params()
    tokens = TRAIN_B * TRAIN_S
    wall = statistics.median(walls[1:TRAIN_STEPS])          # steps 2-8
    peaks = env["peaks"]
    step_bound, _ = bound_ms(0, 6 * active * tokens, peaks, "bf16")
    opt_bound, _ = bound_ms(30 * n_params, 0, peaks, "bf16")
    emit("train", sub="train_main", arch=ARCH, dtype="bfloat16 over fp32 masters",
         batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR, warmup_steps=1, params=n_params,
         losses=losses, losses_resumed=losses_resumed, resume_max_rel_diff=max(spread),
         resume_limit=TRAIN_RESUME_REL, log=log, step_walls_ms=[w * 1e3 for w in walls],
         median_step_wall_ms=wall * 1e3, tokens_per_s=tokens / wall,
         mfu=6 * active * tokens / (wall * peaks["bf16"]),
         step_flops_bound_ms=step_bound, optimizer_bytes_bound_ms=opt_bound,
         peak_memory_bytes=peak, checkpoint_bytes=ckpt_bytes, save_s=save_s, load_s=load_s,
         loaded_bit_identical=True, step_split=split)


def _train_flash(torch, env) -> None:
    """qwen3-1.7b at S=2048 (the chunked flash path), B=1: one full-depth
    step under remat "full"; then 4 layers under remat none / full / dots."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.distributed import steps as ST
    from repro_torch.models.api import get_model
    from repro_torch.models.common import tree_map
    from repro_torch.training import optimizer as OPT

    toks = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, get_config(ARCH).vocab_size, (1, FLASH_S))).to(DEVICE)
    batch = {"tokens": toks, "labels": toks}
    opt = OPT.AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    cfg = dataclasses.replace(get_config(ARCH), remat="full")
    model = get_model(cfg)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    state = OPT.init_state(model.init(SEED, DEVICE))
    sync(torch)
    t0 = time.perf_counter()
    state, met = ST.make_train_step(model, opt_cfg=opt)[0](state, batch)
    sync(torch)
    wall = time.perf_counter() - t0
    loss, gnorm = float(met["loss"]), float(met["grad_norm"])
    check(math.isfinite(loss), f"train_flash: loss {loss}")
    check(math.isfinite(gnorm) and gnorm > 0, f"train_flash: grad norm {gnorm}")
    full_depth = dict(loss=loss, grad_norm=gnorm, wall_ms=wall * 1e3,
                      peak_memory_bytes=torch.cuda.max_memory_allocated())
    del state, met
    _free(torch)
    cfg4 = dataclasses.replace(get_config(ARCH), num_layers=FLASH_REMAT_LAYERS)
    state0 = OPT.init_state(get_model(cfg4).init(SEED, DEVICE))
    remat = {}
    for mode in ("none", "full", "dots"):
        st = tree_map(lambda t: t.clone(), state0)
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step = ST.make_train_step(get_model(dataclasses.replace(cfg4, remat=mode)),
                                  opt_cfg=opt)[0]
        st, met = step(st, batch)
        remat[mode] = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                           peak_memory_bytes=torch.cuda.max_memory_allocated(),
                           peak_above_state_bytes=torch.cuda.max_memory_allocated() - base)
        del st, met
    del state0
    _free(torch)
    for mode in ("full", "dots"):
        dl = abs(remat[mode]["loss"] - remat["none"]["loss"]) / abs(remat["none"]["loss"])
        dg = abs(remat[mode]["grad_norm"] - remat["none"]["grad_norm"]) / remat["none"]["grad_norm"]
        remat[mode].update(loss_rel_diff=dl, grad_norm_rel_diff=dg)
        check(dl <= REMAT_LOSS_REL, f"train_flash: remat {mode} loss off by {dl}")
        check(dg <= REMAT_GNORM_REL, f"train_flash: remat {mode} grad norm off by {dg}")
    emit("train", sub="train_flash", arch=ARCH, seq=FLASH_S, batch=1, full_depth_remat_full=full_depth,
         remat_layers=FLASH_REMAT_LAYERS, remat=remat,
         limits=dict(loss_rel=REMAT_LOSS_REL, grad_norm_rel=REMAT_GNORM_REL))


def _parity_params(torch, cfg):
    """The port's init from SEED on the CPU, with the attention tempered where
    random attention at the init's scale is chaotic (MOE_ATTN_SCALE,
    STATE_TEMPERED)."""
    from repro_torch.models.api import get_model

    params = get_model(cfg).init(SEED, "cpu")
    if cfg.family == "moe":
        for name, factor in MOE_ATTN_SCALE.items():
            params["layers"][name].mul_(factor)
    elif cfg.family in STATE_TEMPERED:
        _temper_attention(torch, cfg, params)
    return params


def _train_parity(torch, env) -> None:
    """One fp32 train step of each family on the card and on the CPU from the
    same weights and batch."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.distributed import steps as ST
    from repro_torch.models.api import get_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training import optimizer as OPT

    opt = OPT.AdamWConfig(**PARITY_OPT)
    rows = []
    for arch, layers, b, s, over in PARITY:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=torch.float32,
                                  **over)
        model = get_model(cfg)
        rng = np.random.RandomState(SEED)
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)))
        batch = {"tokens": toks, "labels": toks}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(
                rng.randn(b, PARITY_FRAMES, cfg.d_model).astype(np.float32))
        runs = {}
        cpu_state = OPT.init_state(_parity_params(torch, cfg))
        card_state = tree_map(lambda t: t.to(DEVICE), cpu_state)
        for dev, st in (("cpu", cpu_state), (DEVICE, card_state)):
            before = [t.clone() for t in tree_leaves(st["master"])] if dev == "cpu" else None
            bt = {k: v.to(dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            loss, grads = ST.loss_and_grads(model, st["master"], bt)
            st, _ = OPT.apply_updates(st, grads, opt, compute_dtype=cfg.dtype)
            if dev != "cpu":
                sync(torch)
            runs[dev] = dict(loss=float(loss), wall_s=time.perf_counter() - t0,
                             grads=[g.cpu() for g in tree_leaves(grads)],
                             master=[w.cpu() for w in tree_leaves(st["master"])])
            if before is not None:
                runs[dev]["update_max"] = max(float((w - w0).abs().max()) for w, w0
                                              in zip(runs[dev]["master"], before))
            del st, grads
        del cpu_state, card_state
        _free(torch)
        c, g = runs["cpu"], runs[DEVICE]
        loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        grad_rel = max(float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                       for a, w in zip(g["grads"], c["grads"]))
        master_abs = max(float((a - w).abs().max()) for a, w in zip(g["master"], c["master"]))
        row = dict(arch=arch, layers=layers, batch=b, tokens=s, family=cfg.family,
                   tempered=cfg.family == "moe" or cfg.family in STATE_TEMPERED,
                   loss_cpu=c["loss"], loss_card=g["loss"], loss_rel_diff=loss_rel,
                   grad_max_rel_diff=grad_rel, master_max_abs_diff=master_abs,
                   master_update_max=c["update_max"], wall_cpu_s=c["wall_s"],
                   wall_card_s=g["wall_s"])
        rows.append(row)
        check(loss_rel <= PARITY_LOSS_REL, f"train_parity {arch}: loss off by {loss_rel}")
        check(grad_rel <= PARITY_GRAD_REL, f"train_parity {arch}: a grad off by {grad_rel}")
        check(master_abs <= PARITY_MASTER_ABS,
              f"train_parity {arch}: master off by {master_abs}")
        del runs
    emit("train", sub="train_parity", opt=PARITY_OPT, rows=rows,
         limits=dict(loss_rel=PARITY_LOSS_REL, grad_rel=PARITY_GRAD_REL,
                     master_abs=PARITY_MASTER_ABS))


def phase_train(torch, env) -> None:
    """Phase 11: the training path on the card; training never reaches K4
    (no backward) or K3."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    before = kernels.launch_counts()
    _train_main(torch, env)
    _train_flash(torch, env)
    _train_parity(torch, env)
    after = kernels.launch_counts()
    moved = {k: after[k] - before[k] for k in ("flash_prefill", "paged_decode_attention")
             if after[k] != before[k]}
    check(not moved, f"train: K4 / K3 launched during training: {moved}")
    emit("train", done=True, k4_k3_launches=0, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# dryrun: the dry-run accounting of every cell, and three reduced cells of
# qwen3-1.7b measured on the card against it
# ---------------------------------------------------------------------------
DRYRUN_WORKERS = 8                     # meta-trace processes (K4 at 32k runs beside them)
# (shape, batch on the card, config overrides): each cell cut only in batch;
# train_4k under the remat mode train_flash runs S=2048 with
DRYRUN_CARD = (("prefill_32k", 1, ""), ("decode_32k", 8, ""), ("train_4k", 1, "remat=full"))
RESIDENT_REL = 5e-3                    # predicted resident bytes vs the allocator's growth
FLOP_SHARE_MAX = 1.05                  # counted FLOPs / device time / 989 TFLOP/s
BYTE_SHARE_MAX = 1.05                  # counted bytes / device time / 3.35 TB/s
K4_LONG = 32768                        # K4 held at prefill_32k's length, bf16 cold
K4_LONG_ROWS = 256                     # first and last rows held against the plain version


def _cell_line(r) -> dict:
    line = dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"], status=r["status"])
    if r["status"] == "ok" and "roofline" in r:
        rf = r["roofline"]
        line.update(flops_per_chip=rf["flops"], resident_bytes_per_device=r[
            "resident_bytes_per_device"], compute_s=rf["compute_s"], memory_s=rf["memory_s"],
            collective_s=rf["collective_s"], bottleneck=rf["bottleneck"],
            temp_bytes_per_device=r["memory_analysis"]["temp_size_in_bytes"],
            trace_s=r["lower_s"])
    elif r["status"] == "ok":                         # a transfer cell
        line.update(pool_bytes_global=r["pool_bytes_global"], plan=r.get("plan"),
                    k1_bytes=r.get("op_counts", {}).get("bytes"))
    else:
        line["why"] = r.get("why") or r.get("error")
    return line


def _card_cell(torch, shape: str, batch: int, opts: str) -> dict:
    """One reduced cell of full-width, full-depth qwen3-1.7b (bf16, seeded
    init) on the card: the allocator's growth for its resident tensors, one
    step's peak, device time (torch.profiler) and wall."""
    import numpy as np
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import steps as ST
    from repro_torch.launch.dryrun import _parse_opts
    from repro_torch.models.api import get_model
    from repro_torch.training import optimizer as OPT

    from torch.profiler import ProfilerActivity, profile

    t_setup = time.perf_counter()
    kind, seq, _ = SHAPES[shape]
    cfg = dataclasses.replace(get_config(ARCH), **_parse_opts(opts))
    model = get_model(cfg)
    _free(torch)
    base = torch.cuda.memory_allocated()
    rng = np.random.RandomState(SEED)
    if kind == "train":
        state = OPT.init_state(model.init(SEED, DEVICE))
        sync(torch)
        resident = torch.cuda.memory_allocated() - base
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))).to(DEVICE)
        batch_t = {"tokens": toks.int(), "labels": toks.int()}
        step_fn = ST.make_train_step(model, opt_cfg=OPT.AdamWConfig(lr=TRAIN_LR,
                                                                   warmup_steps=1))[0]
        box = {"state": state}
        del state

        def step():
            box["state"], met = step_fn(box["state"], batch_t)
            return met["loss"]
    else:
        params = model.init(SEED, DEVICE)
        if kind == "decode":
            cache = model.init_cache(batch, seq, device=DEVICE)
        sync(torch)
        resident = torch.cuda.memory_allocated() - base
        if kind == "prefill":
            toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))).to(DEVICE)
            batch_t = {"tokens": toks.int()}

            def step():
                return model.prefill(params, batch_t)[0]
        else:
            tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch,))).to(DEVICE).int()
            # every step writes the last slot and reads all seq keys (the
            # input length is not advanced: decode returns a new one)
            last = torch.full((batch,), seq - 1, dtype=torch.int32, device=DEVICE)

            def step():
                return model.decode(params, tok, {**cache, "length": last})[0]
    stages = {"setup": time.perf_counter() - t_setup}
    t1 = time.perf_counter()
    out = step()                                      # warm-up
    sync(torch)
    check(bool(torch.isfinite(out.float()).all()), f"dryrun {shape}: non-finite output")
    del out
    _free(torch)
    stages["warm_up"] = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    sync(torch)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    # the device's kernels only: a CPU trace of a train step's ~10^5 ops
    # costs the profiler more than the step
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        sync(torch)
    by_kernel = _device_by_kernel(prof)
    stages["profiled"] = time.perf_counter() - t1
    device_s = sum(by_kernel.values()) / 1e6
    check(device_s > 0, f"dryrun {shape}: the profiler saw no device time")
    top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:6]
    _free(torch)
    return dict(resident_bytes=resident, peak_bytes=peak, wall_s=wall, device_s=device_s,
                device_busy_share=device_s / wall, stages_s=stages,
                top_kernels_ms=[(k[:80], v / 1e3) for k, v in top])


def _k4_long(torch, env) -> dict:
    """K4 bf16 cold at S = T = 32,768 (qwen3-1.7b's heads): its first and
    last K4_LONG_ROWS rows against the plain version computing just those
    rows, timed beside SDPA; the fp32 kernel's split workspace at this shape
    stated from its launch plan, not run."""
    from repro_torch.kernels.flash_prefill import flash_prefill_op, flash_prefill_ref
    from repro_torch.kernels.flash_prefill.ops import flops as k4_flops, launch_plan

    H, KV, hd, s, n = 16, 8, 128, K4_LONG, K4_LONG_ROWS
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)  # noqa: E731
    q, k, v = mk(1, s, H, hd), mk(1, s, KV, hd), mk(1, s, KV, hd)
    before = flash_prefill_op.launches
    out = flash_prefill_op(q, k, v)
    sync(torch)
    check(flash_prefill_op.launches == before + 1, "K4 at 32k did not launch")
    errs = {}
    for name, lo in (("first", 0), ("last", s - n)):
        got = out[:, lo:lo + n].float()
        qs, ks, vs = q[:, lo:lo + n], k[:, :lo + n], v[:, :lo + n]
        same = flash_prefill_ref(qs, ks, vs, q_offset=lo)
        up = flash_prefill_ref(qs.float(), ks.float(), vs.float(), q_offset=lo)
        err = float((got - same.float()).abs().max())
        d = (got - up).abs()
        errs[name] = dict(rows=[lo, lo + n], max_abs_err=err, vs_upcast_err=float(d.max()))
        check(err <= K4_BF16_TOL and bool((d <= up.abs() * 2.0 ** -8 + 1e-5).all()),
              f"K4 at 32k disagrees on its {name} rows: {errs[name]}")
        del got, same, up, d
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    t4 = time_ms(torch, lambda: flash_prefill_op(q, k, v), reps=5, warmup=1, flush=flush)
    # SDPA on k / v repeated to H heads, held to its fused backends: its
    # math backend would form the 32k x 32k scores
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sd = _sdpa(torch, q, k.repeat_interleave(H // KV, dim=2), v.repeat_interleave(H // KV, dim=2), 0)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        tl = time_ms(torch, sd, reps=5, warmup=1, flush=flush)
    del sd
    fl = k4_flops(1, s, s, H, hd, True, 0)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    b4, b4_by = bound_ms(nbytes, fl, env["peaks"], "bf16")
    plan = launch_plan(1, s, s, H, KV, hd, True,
                       torch.cuda.get_device_properties(0).multi_processor_count)
    fp32_ws = plan["tiles"] * KV * plan["splits"] * plan["pairs"] * (hd + 4) * 4
    del q, k, v, out, flush
    _free(torch)
    return dict(S=s, T=s, heads=[H, KV, hd], rows_checked=errs, tol=K4_BF16_TOL, ms=t4,
                library_ms=tl, bound_ms=b4, bound_by=b4_by, flops=fl,
                tflops=fl / t4 / 1e9, bound_share=b4 / t4,
                fp32_split_workspace_bytes=fp32_ws, fp32_plan=plan)


def phase_dryrun(torch, env) -> None:
    """Phase 12: every dry-run cell on meta (a pool of spawned processes);
    three reduced qwen3-1.7b cells measured on the card against their
    predictions; K4 at 32k against its plain version."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    from repro_torch.launch import dryrun as D

    t0 = time.perf_counter()
    # the card cells first, alone: their steps are host-bound, and the
    # meta traces would take the host from them
    card = {shape: _card_cell(torch, shape, b, opts) for shape, b, opts in DRYRUN_CARD}
    card_s = time.perf_counter() - t0
    workers = max(1, min(DRYRUN_WORKERS, os.cpu_count() or 1))
    with cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        preds = {shape: ex.submit(D.predict, ARCH, shape, b, opts)
                 for shape, b, opts in DRYRUN_CARD}
        cells = [ex.submit(D.run_group, *g) for g in D.all_groups(longest_first=True)]
        k4 = _k4_long(torch, env)                     # device-bound: beside the pool
        recs = [r for f in cells for r in f.result()]
        preds = {k: f.result() for k, f in preds.items()}
    meta_s = time.perf_counter() - t0 - card_s
    for r in recs:
        emit("dryrun", sub="cell", **_cell_line(r))
    failed = [(r["arch"], r["shape"], r["mesh"], r.get("error")) for r in recs
              if r["status"] == "failed"]
    check(not failed, f"dryrun: failed cells {failed}")
    peak_flops = env["peaks"]["bf16"]
    rows = []
    for shape, b, opts in DRYRUN_CARD:
        p, c = preds[shape], card[shape]
        rel = abs(c["resident_bytes"] - p["resident_bytes"]) / p["resident_bytes"]
        tflops = p["flops"] / c["device_s"] / 1e12
        share = p["flops"] / c["device_s"] / peak_flops
        byte_share = p["bytes"] / c["device_s"] / env["peaks"]["hbm"]
        roof = p["roofline"]
        predicted_s = max(roof["compute_s"], roof["memory_s"])
        row = dict(shape=shape, batch=b, opts=opts, predicted_resident_bytes=p["resident_bytes"],
                   measured_resident_bytes=c["resident_bytes"], resident_rel_err=rel,
                   measured_peak_bytes=c["peak_bytes"],
                   predicted_peak_bytes=p["resident_bytes"] + p["temp_bytes"],
                   peak_ratio=c["peak_bytes"] / (p["resident_bytes"] + p["temp_bytes"]),
                   counted_flops=p["flops"], counted_bytes=p["bytes"], tflops=tflops,
                   flop_share=share, tbytes_per_s=p["bytes"] / c["device_s"] / 1e12,
                   byte_share=byte_share, roofline_s=predicted_s, roofline_bound=roof["bottleneck"],
                   device_s=c["device_s"], wall_s=c["wall_s"],
                   device_over_roofline=c["device_s"] / predicted_s,
                   device_busy_share=c["device_busy_share"], stages_s=c["stages_s"],
                   kernels_counted=p["kernels"],
                   top_kernels_ms=c["top_kernels_ms"], meta_trace_s=p["trace_s"])
        rows.append(row)
        emit("dryrun", sub="card", arch=ARCH, **row)
        check(rel <= RESIDENT_REL, f"dryrun {shape}: resident bytes off by {rel}")
        check(share <= FLOP_SHARE_MAX,
              f"dryrun {shape}: {tflops} TFLOP/s is {share} of the peak: the count is wrong")
        # the counted bytes are the step's least traffic (each operand read and
        # each result written once): a sound count cannot beat HBM's rate
        check(byte_share <= BYTE_SHARE_MAX,
              f"dryrun {shape}: counted bytes move at {byte_share} of HBM's rate: "
              "the count is wrong")
    emit("dryrun", sub="k4_32k", **k4)
    emit("dryrun", done=True, cells=len(recs),
         ok=sum(r["status"] == "ok" for r in recs),
         skipped=sum(r["status"] == "skipped" for r in recs), workers=workers,
         card_s=card_s, meta_s=meta_s, seconds=time.perf_counter() - t0,
         limits=dict(resident_rel=RESIDENT_REL, flop_share_max=FLOP_SHARE_MAX,
                     byte_share_max=BYTE_SHARE_MAX,
                     k4_bf16=K4_BF16_TOL))


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
    phase_e2e_fleet(torch, env)
    fine_counts = phase_e2e_moe_tp(torch, env)
    phase_sim_calibrate(torch, env)
    state_counts, state_fp32_counts = phase_e2e_state(torch, env)
    phase_train(torch, env)
    phase_dryrun(torch, env)
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
        "kv_transfer_fine": ("src/repro_torch/csrc/kv_transfer.cu",
                             "src/repro/kernels/kv_gather/kv_transfer.py:57", fine_counts),
        "flash_prefill_noncausal": ("src/repro_torch/csrc/flash_prefill.cu",
                                    "src/repro/kernels/flash_prefill/flash_prefill.py:113",
                                    state_counts),
        "flash_prefill_noncausal_fp32": ("src/repro_torch/csrc/flash_prefill.cu",
                                         "src/repro/kernels/flash_prefill/flash_prefill.py:113",
                                         state_fp32_counts),
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
