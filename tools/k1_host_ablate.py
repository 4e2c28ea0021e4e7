#!/usr/bin/env python3
"""Time K1's designs (``csrc/kv_transfer.cu``) on the card, one beside
another in one process, with the PyTorch calls that make the same moves.

The host route: the host tier moves whole blocks between a CUDA pool and a
pinned host pool, demote (card -> host) and promote (host -> card), timed on
``chip_smoke.py``'s tier shape (the 33 blocks of a 1056-token qwen3-1.7b
prefix in float32, 1848 pages of 128 KiB, 242 MB) in the design K1 ships
for it (one 256-thread block a page over the pinned pool's mapped pages),
beside ``index_select`` + ``copy_`` into pinned memory and the reverse
(``copy_`` + ``index_copy_``), and a contiguous ``copy_`` of the same bytes
each way, all on the copy engines. Three rounds in turns.

The card route: the small-row design against one block a row
(``ops.block_a_row``), with the L2 flushed before each call,

* at row widths of 16 B to 64 KiB over ~19 MB of rows (one shard pair's
  launch of chip_smoke's TP 2 -> 4 fine rows is 18.5 MB), at the decode
  append's 448 rows of 2 KiB and the P->D transfer's 1792 pages of 64 KiB
  (CUDA events), and at 128 B with 1-8 rows in flight a group: this picks
  ``ops.ROWS_BELOW``;
* over short tables, 48 to 6144 rows of 128 B to 1 KiB, device time only
  (torch.profiler): the decode appends of granite-moe-1b-a400m are
  2 x 24 x B rows (B = 1, 2, 4) of 1 KiB (bf16, TP 1), 512 B (bf16 TP 2,
  fp32 TP 4) or 256 B (bf16 TP 4). This picks ``ops.rows_from``.

Every design is first held bit-exact against the plain version. Nothing is
compiled but the shipped library: the geometry is an argument of the
launch.

    python3 tools/k1_host_ablate.py     # on a machine with an H100 and nvcc

Prints the nvidia-smi name and power limit, the host time of one launch of
the fine rows, one JSON line per host-route round (CUDA events, median of
10 calls a case), one line for the card route and one for the short tables.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

ROW_WIDTHS = (16, 128, 512, 1024, 2048, 4096, 8192, 65536)
ROW_BYTES_TOTAL = 19 << 20
CARD_BUFFER = 160 << 20                # each side's pool: the P->D case's 1792 pages fit
FINE_IN_FLIGHT = (1, 2, 4, 8)
SHORT_WIDTHS = (128, 256, 512, 1024)
SHORT_ROWS = (48, 96, 192, 384, 768, 1056, 1536, 3072, 6144)
ROUNDS = 3


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k1_host_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import TransferPlanner
    from repro_torch.kernels.kv_gather import kv_transfer, kv_transfer_ref
    from repro_torch.kernels.kv_gather import ops
    from repro_torch.serving.kv_cache import spec_for_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    # -- the host route on the tier's shape (fp32) -------------------------------
    cfg = dataclasses.replace(get_config(cs.ARCH), dtype=torch.float32)
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
    npages = int(dsp.numel())
    nbytes = npages * spec.payload * 4
    ids = torch.as_tensor(blocks, device=dev)
    hview = host[20:20 + n]
    dev_contig = pool[5:5 + n].clone()
    want = torch.zeros_like(pool)                  # the pages a round trip names, else 0
    want[blocks] = pool[blocks]
    host.zero_()
    kv_transfer(pool, host, dsp, ddp)
    kv_transfer(host, back, usp, udp)
    cs.sync(torch)
    cs.check(torch.equal(back.view(torch.int32), want.view(torch.int32)),
             "k1_host_ablate: the host round trip is not bit-exact")
    print(json.dumps({"host_route": {"bytes": nbytes, "pages": npages, "blocks": n,
                                     "promote": dataclasses.asdict(ops.k1_design(
                                         spec.payload * 4, 0, True, False, npages, sms)),
                                     "demote": dataclasses.asdict(ops.k1_design(
                                         spec.payload * 4, 0, False, True, npages, sms))}}),
          flush=True)
    for rnd in range(ROUNDS):
        row = {"round": rnd, "unit": "ms", "card": smi.stdout.strip()}
        cases = {"demote (one block a page)": lambda: kv_transfer(pool, host, dsp, ddp),
                 "promote (one block a page)": lambda: kv_transfer(host, back, usp, udp),
                 "library demote (index_select + copy_)":
                 lambda: hview.copy_(pool.index_select(0, ids), non_blocking=True),
                 "library promote (copy_ + index_copy_)":
                 lambda: back.index_copy_(0, ids, hview.to(dev, non_blocking=True)),
                 "contiguous copy_ card->host": lambda: hview.copy_(dev_contig, non_blocking=True),
                 "contiguous copy_ host->card": lambda: dev_contig.copy_(hview, non_blocking=True)}
        for k, fn in cases.items():
            row[k] = cs.time_ms(torch, fn, reps=10)
        row["bound_ms gen5 x16"] = nbytes / (16 * cs.PCIE_LANE_BPS[5]) * 1e3
        print(json.dumps(row), flush=True)
    del pool, back, host, want, dev_contig

    # -- the card route: rows of 16 B - 64 KiB ------------------------------------
    src_flat = torch.randn(CARD_BUFFER // 2, generator=gen, device=dev).to(torch.bfloat16)
    dst_flat = torch.zeros_like(src_flat)

    def case(w, rows):
        total = CARD_BUFFER // w                   # rows the buffers hold
        sv, dv = src_flat.view(-1, w // 2), dst_flat.view(-1, w // 2)
        sp = torch.randperm(total, generator=gen, device=dev)[:rows].to(torch.int32)
        dp = torch.randperm(total, generator=gen, device=dev)[:rows].to(torch.int32)
        return sv, dv, sp, dp

    def exact(name, c, designs):
        sv, dv, sp, dp = c
        for dname, d in designs.items():
            dst_flat.zero_()
            ref = torch.zeros_like(dv)
            ops.kv_transfer_design(sv, dv, sp, dp, d)
            kv_transfer_ref(sv, ref, sp, dp)
            cs.sync(torch)
            cs.check(torch.equal(dv.view(torch.int16), ref.view(torch.int16)),
                     f"k1_host_ablate: {name} {dname} not bit-exact")

    card = {f"{w} B x {ROW_BYTES_TOTAL // w}": (w, ROW_BYTES_TOTAL // w) for w in ROW_WIDTHS}
    card["append 2048 B x 448"] = (2048, 448)
    card["P->D 65536 B x 1792"] = (65536, 1792)
    row = {"unit": "ms", "card": smi.stdout.strip(), "rows_below": ops.ROWS_BELOW}
    fine = None
    for name, (w, rows) in card.items():
        c = case(w, rows)
        designs = {"one block a row": ops.block_a_row(w, 0, rows),
                   "rows": ops.rows_design(w, 16, rows, sms)}
        if w == 128:
            fine = c
            cap = sms * ops.ROWS_BLOCKS_PER_SM
            designs.update({f"rows, {k} in flight": ops.K1Design(
                "rows", word=16, lanes=8, in_flight=k, grid=min(cap, -(-rows // (32 * k))))
                for k in FINE_IN_FLIGHT})
        exact(name, c, designs)
        sv, dv, sp, dp = c
        row[f"{name} bound"] = (2 * rows * w + 2 * rows * 4) / 3.35e12 * 1e3
        for dname, d in designs.items():
            row[f"{name} {dname}"] = cs.time_ms(
                torch, lambda: ops.kv_transfer_design(sv, dv, sp, dp, d), flush=flush)
        sl, dl = sp.long(), dp.long()
        row[f"{name} index_select + index_copy_"] = cs.time_ms(
            torch, lambda: dv.index_copy_(0, dl, sv.index_select(0, sl)), flush=flush)
    print(json.dumps({"host_us_a_call": _host_us(torch, fine)}), flush=True)
    print(json.dumps(row), flush=True)

    # -- short tables: the decode appends' row counts -----------------------------
    row = {"unit": "ms device", "card": smi.stdout.strip(),
           "rows_from": {w: ops.rows_from(w) for w in SHORT_WIDTHS}}
    for w in SHORT_WIDTHS:
        for rows in SHORT_ROWS:
            c = case(w, rows)
            designs = {"one block a row": ops.block_a_row(w, 0, rows),
                       "rows": ops.rows_design(w, 16, rows, sms)}
            exact(f"{w} B x {rows}", c, designs)
            sv, dv, sp, dp = c
            for dname, d in designs.items():
                row[f"{w} B x {rows} {dname}"] = cs.device_only_ms(
                    torch, lambda: ops.kv_transfer_design(sv, dv, sp, dp, d),
                    "kv_transfer_rows" if d.design == "rows" else "kv_transfer_kernel",
                    flush=flush)
            row[f"{w} B x {rows} shipped"] = ops.k1_design(w, 0, False, False, rows, sms).design
    print(json.dumps(row), flush=True)
    return 0


def _host_us(torch, case) -> dict:
    """Host microseconds a call of the public wrappers over the fine rows
    (the launch is asynchronous: this is its enqueue), beside the library's
    two calls, over 200 calls after a warm-up."""
    import time

    from repro_torch.kernels.kv_gather import kv_transfer, kv_transfer_fine

    sv, dv, sp, dp = case
    sl, dl = sp.long(), dp.long()
    out = {}
    for name, fn in (("kv_transfer", lambda: kv_transfer(sv, dv, sp, dp)),
                     ("kv_transfer_fine", lambda: kv_transfer_fine(sv, dv, sp, dp, sv.shape[-1])),
                     ("index_select + index_copy_",
                      lambda: dv.index_copy_(0, dl, sv.index_select(0, sl)))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    sys.exit(main())
