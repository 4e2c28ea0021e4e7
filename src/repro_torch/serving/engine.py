"""Per-node inference engine: executes the hybrid scheduler's decisions with
real PyTorch compute against the paged pool. Port of
``repro/serving/engine.py`` (paged path).

Paged KV path (dense transformer family): prefill writes pages; decode runs
the ZERO-GATHER step — one ``Model.decode_paged`` call per cycle that reads
pages in place through the paged-attention kernel (K3) and appends the
batch's new K/V with one fused K1 launch, the pool updated in place. The
gather-dense bridge survives as the oracle (``paged_decode="dense"``) and
as the path for windowed attention.

"One dispatch per decode cycle" keeps the reference's meaning: one
host-issued step call (``decode_dispatches`` counts those). In eager torch
that call makes many kernel launches (K3 once per layer, K1 once); capturing
each bucket's step as a CUDA graph — the analogue of the reference's jit
cache — is ROADMAP work.

Ragged batches are padded to power-of-two buckets in BOTH batch size and
block-table width (pad lanes replicate lane 0, so their duplicate append
descriptors are idempotent); ``decode_compile_variants`` counts the buckets
seen. State families and tensor parallelism are not ported (ROADMAP items
11 and 9).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.scheduler.hybrid_scheduler import HybridScheduler, ScheduleDecision
from repro_torch.models.api import Model, get_model
from repro_torch.models.common import ModelConfig
from repro_torch.serving.kv_cache import PagedKVCache, spec_for_model
from repro_torch.serving.request import Request


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class NodeEngine:
    """Role-flexible node: serves prefill AND decode from ONE block pool.

    A node's *role* lives in the controller's ``NodeHandle`` and only biases
    routing and scheduler priority — the engine runs whatever its
    ``HybridScheduler`` admits, so ``GlobalController.set_role`` can flip a
    node P<->D mid-run without draining it.
    """

    def __init__(self, node_id: int, cfg: ModelConfig, params,
                 num_blocks: int = 256, allocator: str = "flowkv",
                 max_batch_tokens: int = 2048, max_model_len: int = 512,
                 paged_decode: str = "auto", chunked_prefill: bool = True,
                 prefill_chunk_tokens: Optional[int] = None,
                 tp_degree: int = 1, device=None):
        if tp_degree != 1:
            raise NotImplementedError(
                "tp_degree > 1 is not ported yet: see ROADMAP.md item 9")
        self.node_id = node_id
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: Model = get_model(cfg)
        self.params = params
        self.max_model_len = max_model_len
        self.paged = True             # KV lives in the paged pool (backend_for_engine)
        self.tp_degree = 1
        self.ep_degree = 1
        self.kv = PagedKVCache(spec_for_model(cfg, num_blocks), allocator,
                               device=self.device)
        # Chunked prefill needs the suffix data plane: an intermediate chunk
        # is exactly a suffix prefill (q_offset = tokens done) over the pool.
        self.supports_chunked_prefill = self.model.prefill_suffix is not None
        self.scheduler = HybridScheduler(
            node_id, self.kv.bm, max_batch_tokens=max_batch_tokens,
            chunked_prefill=chunked_prefill and self.supports_chunked_prefill,
            prefill_chunk_tokens=prefill_chunk_tokens)
        # -- spill path (decode memory pressure) --------------------------------------
        # request_id -> (k, v, length) saved host-side when the scheduler
        # preempts a decode request; restored into fresh blocks on resume.
        self.spilled: Dict[int, Tuple[torch.Tensor, torch.Tensor, int]] = {}
        self.scheduler.on_spill = self._spill_kv
        self.scheduler.on_resume = self._restore_kv
        self.scheduler.on_discard = lambda req: self.spilled.pop(req.request_id, None)
        # -- zero-gather decode plane ------------------------------------------------
        # paged_decode: "auto" (kernel when supported), "kernel", "dense" (oracle).
        if paged_decode not in ("auto", "kernel", "dense"):
            raise ValueError(f"paged_decode must be auto|kernel|dense, got {paged_decode!r}")
        kernel_ok = self.model.decode_paged is not None
        if paged_decode == "kernel" and not kernel_ok:
            raise ValueError("paged_decode='kernel' unsupported for this config "
                             "(windowed attention)")
        self.use_paged_decode = kernel_ok and paged_decode != "dense"
        self.decode_steps = 0          # decode cycles executed
        self.decode_dispatches = 0     # host-issued step calls those cycles made
        self._decode_cache_keys: Set[Tuple[int, int]] = set()   # buckets seen
        # -- prefix-reuse data plane ---------------------------------------------------
        self.supports_prefix_reuse = self.model.prefill_suffix is not None
        self.tier = None                   # host tier: not ported (ROADMAP item 8)
        self.prefill_tokens_computed = 0   # prompt tokens actually forwarded
        self.prefix_hits = 0               # prefills that reused a resident prefix
        self.prefix_tokens_reused = 0      # prompt tokens NOT recomputed
        # -- observability ------------------------------------------------------------
        self.tracer = None

    @property
    def decode_compile_variants(self) -> int:
        """Distinct (batch, block-table-width) buckets the step ran."""
        return len(self._decode_cache_keys)

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor([list(ids)], dtype=torch.int32).to(self.device)

    # -- prefill ------------------------------------------------------------------
    def run_prefill(self, decision: ScheduleDecision,
                    now: Optional[float] = None) -> List[Request]:
        """Execute the prefill batch; returns requests that finished prefill.

        Honors the scheduler's per-request CHUNK budget: an intermediate
        chunk runs as a suffix prefill — prefix K/V gathered from the paged
        pool, the chunk's tokens forwarded at ``q_offset = tokens_done``, the
        new pages written back at ``start = tokens_done``. A chunk that
        starts at 0 and covers the whole prompt takes the monolithic path.
        The first output token comes from the FINAL chunk, so TTFT is
        stamped here.
        """
        done: List[Request] = []
        for req in decision.prefill_batch:
            if now is not None and req.prefill_start is None:
                req.prefill_start = now
            if req.prefill_start_wall is None:
                req.prefill_start_wall = time.monotonic()
            offset = self.scheduler.prefill_tokens_done(req)
            chunk = decision.prefill_chunks.get(
                req.request_id, req.prompt_len - offset)
            chunk = min(chunk, req.prompt_len - offset)
            if chunk <= 0:
                continue
            final = offset + chunk == req.prompt_len
            if final:
                req.last_prefill_chunk_tokens = chunk
            cached = req.num_cached_prefix_tokens if self.supports_prefix_reuse else 0
            chunk_wall = time.monotonic()
            if offset > 0:
                # Suffix chunk: attend over the resident prefix K/V (cached
                # prefix blocks plus earlier chunks' pages) and write only
                # this chunk's pages.
                k_pre, v_pre = self.kv.gather_prefix(req.request_id, offset)
                tokens = self._tokens(req.prompt_tokens[offset:offset + chunk])
                logits, cache = self.model.prefill_suffix(
                    self.params, {"tokens": tokens}, k_pre[:, None], v_pre[:, None])
                self.kv.write_prefill(req.request_id, cache["k"][:, 0],
                                      cache["v"][:, 0], chunk, start=offset)
                if offset == cached and cached > 0:
                    self.prefix_hits += 1
                    self.prefix_tokens_reused += cached
            else:
                tokens = self._tokens(req.prompt_tokens[:chunk])
                logits, cache = self.model.prefill(self.params, {"tokens": tokens})
                self.kv.write_prefill(req.request_id, cache["k"][:, 0],
                                      cache["v"][:, 0], chunk)
            if final and not req.output_tokens:
                # only the last chunk's last position predicts the next token;
                # a recovery prefill (output_tokens non-empty) keeps its token
                req.output_tokens.append(int(torch.argmax(logits[0])))
            self.prefill_tokens_computed += chunk
            if self.tracer is not None:
                self.tracer.emit(
                    req.request_id, "prefill_chunk",
                    start_cycle=now, end_cycle=now,
                    start_wall_s=chunk_wall, end_wall_s=time.monotonic(),
                    node_id=self.node_id,
                    attrs={"offset": offset, "tokens": chunk,
                           "prompt_len": req.prompt_len, "final": final})
            if self.scheduler.prefill_progressed(req, chunk):
                if now is not None and req.first_token_time is None:
                    req.first_token_time = now
                wall = time.monotonic()
                req.prefill_end_wall = wall
                if req.first_token_wall is None:
                    req.first_token_wall = wall
                if self.tracer is not None:
                    self.tracer.emit(
                        req.request_id, "prefill",
                        start_cycle=req.prefill_start, end_cycle=now,
                        start_wall_s=req.prefill_start_wall,
                        end_wall_s=wall, node_id=self.node_id,
                        attrs={"prompt_len": req.prompt_len,
                               "cached_prefix_tokens": cached})
                done.append(req)
        self.scheduler.last_compute_util = 1.0 if decision.prefill_batch else 0.0
        return done

    # -- decode --------------------------------------------------------------------
    def run_decode(self, decision: ScheduleDecision) -> List[Request]:
        """One decode step for the running batch; returns finished requests."""
        batch = decision.decode_batch
        if not batch:
            return []
        finished: List[Request] = []
        decoded = self._decode_paged(batch)
        for req in batch:
            last = req.output_tokens[-1]
            eos = req.sampling.eos_token_id
            if req.num_output >= req.sampling.max_new_tokens or (eos is not None and last == eos):
                finished.append(req)
                self.scheduler.decode_finished(req)
        # bandwidth pressure = fraction of the admitted batch that decoded
        self.scheduler.last_bandwidth_util = decoded / max(1, len(batch))
        return finished

    def _decode_paged(self, batch: List[Request]) -> int:
        if self.use_paged_decode:
            return self._decode_paged_kernel(batch)
        return self._decode_paged_dense(batch)

    def _decode_paged_kernel(self, batch: List[Request]) -> int:
        """Zero-gather step: ONE host-issued step call for the whole batch.

        Batch and block-table width are padded to power-of-two buckets; pad
        lanes replicate lane 0 (same token / length / block-table row), so
        their append descriptors duplicate lane 0's writes bit-identically
        instead of aiming at block 0.
        """
        b = len(batch)
        # KV cached so far = prompt + all outputs except the newest token,
        # whose KV is written by THIS step at position total-1.
        lens = [r.total_len - 1 for r in batch]
        toks = [r.output_tokens[-1] for r in batch]
        tables = self.kv.export_block_tables([r.request_id for r in batch])
        bp = _next_pow2(b)
        wp = _next_pow2(tables.shape[1])
        bt = np.zeros((bp, wp), np.int32)
        bt[:b, :tables.shape[1]] = tables
        bt[b:] = bt[0]
        tok_arr = np.full((bp,), toks[0], np.int32)
        tok_arr[:b] = toks
        len_arr = np.full((bp,), lens[0], np.int32)
        len_arr[:b] = lens
        self._decode_cache_keys.add((bp, wp))
        dev = self.device
        # decode_dispatches counts host-issued step calls: this branch makes
        # exactly ONE (the argmax below is a host read of its output).
        logits, _ = self.model.decode_paged(
            self.params, torch.from_numpy(tok_arr).to(dev), self.kv.pool,
            torch.from_numpy(bt).to(dev), torch.from_numpy(len_arr).to(dev))
        self.kv.num_pool_dispatches += 1
        self.decode_steps += 1
        self.decode_dispatches += 1
        nxt = torch.argmax(logits[:b], dim=-1).cpu().tolist()
        for i, r in enumerate(batch):
            r.output_tokens.append(int(nxt[i]))
            r.decode_steps += 1
            r.decode_dispatches += 1
        return b

    def _decode_paged_dense(self, batch: List[Request]) -> int:
        """Gather-dense oracle: densify pages per request, decode, write back
        per request — O(batch) host-issued operations per step."""
        max_len = max(r.total_len for r in batch) + 1
        ks, vs, lens, toks = [], [], [], []
        for r in batch:
            k, v = self.kv.gather_dense(r.request_id, max_len)
            ks.append(k)
            vs.append(v)
            lens.append(r.total_len - 1)
            toks.append(r.output_tokens[-1])
        cache = {
            "k": torch.stack(ks, dim=1),            # (L, B, T, KV, hd)
            "v": torch.stack(vs, dim=1),
            "length": torch.as_tensor(lens, dtype=torch.int32).to(self.device),
        }
        logits, new_cache = self.model.decode(
            self.params, torch.as_tensor(toks, dtype=torch.int32).to(self.device), cache)
        nxt = torch.argmax(logits, dim=-1).cpu().tolist()
        step_dispatches = 2 * len(batch) + 1   # B gathers + decode + B appends
        for i, r in enumerate(batch):
            pos = lens[i]
            self.kv.append_token(r.request_id, new_cache["k"][:, i, pos],
                                 new_cache["v"][:, i, pos], pos)
            r.output_tokens.append(int(nxt[i]))
            r.decode_steps += 1
            r.decode_dispatches += step_dispatches
        self.decode_steps += 1
        self.decode_dispatches += step_dispatches
        return len(batch)

    # -- spill path (scheduler hooks) ------------------------------------------------
    def _spill_kv(self, req: Request) -> None:
        """Save a preempted request's KV host-side before its blocks free.

        KV cached at preemption covers positions [0, total_len-1).
        """
        length = req.total_len - 1
        k, v = self.kv.gather_dense(req.request_id, length)
        self.spilled[req.request_id] = (k.cpu(), v.cpu(), length)

    def _restore_kv(self, req: Request) -> None:
        """Refill fresh blocks with the saved KV when a swap resumes."""
        entry = self.spilled.pop(req.request_id, None)
        if entry is None:
            return   # nothing was spilled (e.g. prefill-side swap, no KV yet)
        k, v, length = entry
        self.kv.write_prefill(req.request_id, k.to(self.device), v.to(self.device),
                              length)

    # -- transfer hooks (TransferBackend ports; see core/transfer.py) -------------------
    def register_transfer_in(self, req: Request, num_tokens: int) -> List[int]:
        """Destination-side block registration ahead of a paged transfer."""
        return self.scheduler.bm.register(req.request_id, num_tokens)

    # -- lifecycle -----------------------------------------------------------------------
    def release(self, req: Request) -> bool:
        """Drop every trace of a request from this node (cancel path)."""
        return self.scheduler.remove_request(req)

    # -- cycle -----------------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> Tuple[List[Request], List[Request]]:
        """One scheduling cycle. Returns (prefill_done, decode_finished)."""
        decision = self.scheduler.schedule()
        pre = self.run_prefill(decision, now=now) if decision.prefill_batch else []
        fin = self.run_decode(decision) if decision.decode_batch else []
        if not decision.prefill_batch:
            self.scheduler.last_compute_util = 0.0
        if not decision.decode_batch:
            self.scheduler.last_bandwidth_util = 0.0
        return pre, fin
