"""Per-node inference engine: executes the hybrid scheduler's decisions with
real PyTorch compute. Port of ``repro/serving/engine.py``.

Two request-state transports, as in the reference:

* paged KV path (transformer families): prefill writes pages; decode runs
the ZERO-GATHER step — one ``Model.decode_paged`` call per cycle that reads
pages in place through the paged-attention kernel (K3) and appends the
batch's new K/V with one fused K1 launch, the pool updated in place. The
gather-dense bridge survives as the oracle (``paged_decode="dense"``) and
as the path for windowed attention.
* state path (ssm / hybrid): the request's cache dict is held whole in
  ``states`` and shipped whole (``core/transfer.StateBackend``); decode runs
  one ``Model.decode`` call per request. No chunked prefill, no spill and
  no prefix reuse: those need pages.
* paged plus state slots (granitemoehybrid): the attention layers' K/V in
  the paged pool as above, each request's Mamba-2 state in a slot of
  ``serving/state_slots.StateSlots`` from its first chunk to its finish
  (a request that finds no slot free waits, as it would for blocks).
  Chunks carry the slot's state (``Model.prefill_chunk``); decode is the
  same one batched step over pages and slots, graphs included, its pad
  lanes on a scratch block and a scratch slot; a spill saves the slot's
  row with the pages; P->D moves the pages and the row
  (``core/transfer.PagedStateBackend``). No prefix reuse: pages alone
  cannot restore a Mamba-2 state.

"One dispatch per decode cycle" keeps the reference's meaning: one
host-issued step call (``decode_dispatches`` counts those), which makes many
kernel launches (K3 once per layer, K1 once).

Ragged batches are padded to power-of-two buckets in BOTH batch size and
block-table width (pad lanes replicate lane 0, so their duplicate append
descriptors are idempotent); ``decode_compile_variants`` counts the buckets
seen. On a CUDA engine at ``tp_degree == 1`` whose paged forward has static
shapes (``Model.decode_paged_static``: every paged family but the top-1
sparse MoE dispatch, which reads expert ids on the host), each bucket's step
is captured as a CUDA graph at its first sight, after an eager run of it,
and replayed after that (``serving/decode_graphs.py``), the analogue of the
reference's jit cache: the step's inputs go in by asynchronous copies from
pinned memory and the replay enqueues the whole forward at once.
``decode_graph_captures`` / ``decode_graph_replays`` count both. The
sharded step, the dense oracle, the state path and every CPU engine run
eagerly.

The enc-dec family is refused: its prefill needs the request's encoder
frames, which a request does not carry. The reference fails the same way at
its first prefill (``KeyError: 'frames'``); see ROADMAP.md queue 3.

``tp_degree > 1`` runs the model sharded over a model axis (TP for
attention and MLP, EP for MoE experts) on the one device, with the pool
split into per-kv-head-slice shard pools (``ShardedKVCache``); see
``distributed/tp.py``. The sharded step launches K3 once per shard per
layer and K1 once per shard pool for the append.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.block_manager import BlockManager
from repro_torch.core.scheduler.hybrid_scheduler import HybridScheduler, ScheduleDecision
from repro_torch.distributed import tp as tp_mod
from repro_torch.models.api import Model, get_model
from repro_torch.models.common import ModelConfig
from repro_torch.serving.decode_graphs import DecodeGraphs
from repro_torch.serving.kv_cache import PagedKVCache, ShardedKVCache, spec_for_model
from repro_torch.serving.request import Request
from repro_torch.serving.state_slots import StateSlots

PAGED_FAMILIES = ("dense", "moe", "vlm", "audio")
SLOT_FAMILIES = ("granitemoehybrid",)


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
        self.node_id = node_id
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: Model = get_model(cfg)
        self.params = params
        self.max_model_len = max_model_len
        if cfg.family == "encdec":
            raise ValueError(
                "the enc-dec family cannot be served: its prefill needs encoder "
                "frames, which requests do not carry (ROADMAP.md queue 3)")
        self.paged = cfg.family in PAGED_FAMILIES + SLOT_FAMILIES
        self.slots: Optional[StateSlots] = None
        # -- mesh parallelism ---------------------------------------------------------
        # tp_degree > 1: the model runs sharded over a model axis, the pool
        # split into per-kv-head-slice shard pools (distributed/tp.py).
        self.tp_degree = tp_degree
        self.ep_degree = tp_mod.ep_degree(cfg, tp_degree)
        self.shard_params: Optional[List] = None
        self.merged_combine = None
        if tp_degree > 1:
            if not self.paged or cfg.family in SLOT_FAMILIES:
                raise ValueError("tp_degree > 1 requires a paged-KV family without "
                                 f"state slots, got {cfg.family!r}")
            tp_mod.validate_tp(cfg, tp_degree)
            self.shard_params = tp_mod.shard_params(params, cfg, tp_degree)
            # the combine weights concatenated once, not once a step
            self.merged_combine = tp_mod.merged_combine(self.shard_params, cfg)
            self.kv = ShardedKVCache(spec_for_model(cfg, num_blocks), tp_degree,
                                     allocator, device=self.device)
        elif cfg.family in SLOT_FAMILIES:
            # the pool holds one block past the block manager's: the pad
            # lanes' scratch block, which no request's table holds
            self.kv = PagedKVCache(spec_for_model(cfg, num_blocks + 1), allocator,
                                   bm=BlockManager(num_blocks, cfg.block_size, allocator),
                                   device=self.device)
            self.slots = StateSlots(cfg, cfg.state_slots, self.device)
        elif self.paged:
            self.kv = PagedKVCache(spec_for_model(cfg, num_blocks), allocator,
                                   device=self.device)
        else:
            # state path: a block manager still gates admission (token
            # budget), but the state lives in a per-request dict store
            self.kv = None
        bm = self.kv.bm if self.paged else BlockManager(num_blocks, cfg.block_size, allocator)
        self.states: Dict[int, Dict[str, torch.Tensor]] = {}   # request_id -> state
        # Chunked prefill needs the suffix data plane: an intermediate chunk
        # is exactly a suffix prefill (q_offset = tokens done) over the pool.
        self.supports_chunked_prefill = self.paged and (
            self.model.prefill_suffix is not None or self.model.prefill_chunk is not None)
        self.scheduler = HybridScheduler(
            node_id, bm, max_batch_tokens=max_batch_tokens,
            chunked_prefill=chunked_prefill and self.supports_chunked_prefill,
            prefill_chunk_tokens=prefill_chunk_tokens)
        # -- spill path (decode memory pressure) --------------------------------------
        # request_id -> (k, v, length) saved host-side when the scheduler
        # preempts a decode request; restored into fresh blocks on resume.
        # Paged engines only: the state path keeps its dict in ``states``.
        self.spilled: Dict[int, Tuple[torch.Tensor, torch.Tensor, int]] = {}
        self.spilled_state: Dict[int, torch.Tensor] = {}   # request_id -> slot row
        if self.paged:
            self.scheduler.on_spill = self._spill_kv
            self.scheduler.on_resume = self._restore_kv
            self.scheduler.on_discard = self._discard
        if self.slots is not None:
            self.scheduler.can_admit = self._take_slot
            # the decode step as the graphs call it, the slots bound once
            self._slot_step = lambda p, tok, pool, bt, lens, slot_ids: \
                self.model.decode_paged(p, tok, pool, bt, lens, slot_ids, self.slots)
        # -- zero-gather decode plane ------------------------------------------------
        # paged_decode: "auto" (kernel when supported), "kernel", "dense" (oracle).
        if paged_decode not in ("auto", "kernel", "dense"):
            raise ValueError(f"paged_decode must be auto|kernel|dense, got {paged_decode!r}")
        kernel_ok = self.paged and self.model.decode_paged is not None
        if paged_decode == "kernel" and not kernel_ok:
            raise ValueError("paged_decode='kernel' unsupported for this config "
                             "(state family or windowed attention)")
        self.use_paged_decode = kernel_ok and paged_decode != "dense"
        self.decode_steps = 0          # decode cycles executed
        self.decode_dispatches = 0     # host-issued step calls those cycles made
        self._decode_cache_keys: Set[Tuple[int, int]] = set()   # buckets seen
        self._step_attrs: Optional[dict] = None   # the traced decode step's span attrs
        # the paged step replayed from a CUDA graph a bucket, where the
        # engine can see that it may be captured
        self.graphs: Optional[DecodeGraphs] = None
        if (self.use_paged_decode and tp_degree == 1 and self.device.type == "cuda"
                and self.model.decode_paged_static):
            self.graphs = DecodeGraphs(self.device, cfg.num_kv_heads)
        # -- prefix-reuse data plane ---------------------------------------------------
        self.supports_prefix_reuse = self.paged and self.model.prefill_suffix is not None
        # Optional repro_torch.serving.host_tier.TierManager, attached by
        # the cluster when host_tier_blocks > 0 (reuse-capable engines
        # only): the node's host-DRAM tier for demoted prefix blocks.
        self.tier = None
        self.prefill_tokens_computed = 0   # prompt tokens actually forwarded
        self.prefix_hits = 0               # prefills that reused a resident prefix
        self.prefix_tokens_reused = 0      # prompt tokens NOT recomputed
        # -- observability ------------------------------------------------------------
        self.tracer = None

    @property
    def decode_compile_variants(self) -> int:
        """Distinct (batch, block-table-width) buckets the step ran."""
        return len(self._decode_cache_keys)

    @property
    def decode_graph_captures(self) -> int:
        """Paged steps that ran eagerly and captured their bucket's graph."""
        return 0 if self.graphs is None else self.graphs.captures

    @property
    def decode_graph_replays(self) -> int:
        """Paged steps served by replaying their bucket's graph."""
        return 0 if self.graphs is None else self.graphs.replays

    @property
    def state_slots_peak(self) -> int:
        """Most state slots held at once (0 without slots)."""
        return 0 if self.slots is None else self.slots.peak_held

    @property
    def state_spills(self) -> int:
        """State slots saved to the host by decode preemptions."""
        return 0 if self.slots is None else self.slots.spills

    # -- state slots ----------------------------------------------------------------
    def _take_slot(self, req: Request) -> bool:
        """Scheduler hook: the request's slot, taken now if free."""
        return self.slots.acquire(req.request_id) is not None

    def can_accept_transfer(self, req: Request) -> bool:
        """Whether a transfer of ``req`` may land here now: a free state
        slot where the node holds slots."""
        return self.slots is None or self.slots.owns(req.request_id) \
            or self.slots.num_free > 0

    def drop_state(self, request_id: int) -> None:
        """Free whatever request state the node holds outside its blocks:
        the state path's dict and the state slot."""
        self.states.pop(request_id, None)
        if self.slots is not None:
            self.slots.release(request_id)

    def _discard(self, req: Request) -> None:
        """Scheduler hook: the request left the node for good."""
        self.spilled.pop(req.request_id, None)
        self.spilled_state.pop(req.request_id, None)
        self.drop_state(req.request_id)

    def _prefill_slot_chunk(self, req: Request, offset: int, tokens: torch.Tensor,
                            k_pre, v_pre):
        """One chunk from the slot's carried state (zeros for the first),
        its new state written back into the slot."""
        slots, rid = self.slots, req.request_id
        if slots.acquire(rid) is None:
            raise RuntimeError(f"request {rid} prefills without a state slot")
        slot = slots.slot_of(rid)
        conv = h = None
        if offset > 0:
            conv, h = slots.conv[slot][:, None], slots.h[slot][:, None]
            k_pre, v_pre = k_pre[:, None], v_pre[:, None]
        logits, cache, conv, h = self.model.prefill_chunk(self.params, tokens, k_pre, v_pre,
                                                          conv, h)
        slots.store(rid, conv[:, 0], h[:, 0])
        return logits, cache

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
            # traced: the chunk's phase stamps (prep, upload, launch, write,
            # readback); untraced, no clock read
            stamps = None if self.tracer is None else {}
            if offset > 0:
                # Suffix chunk: attend over the resident prefix K/V (cached
                # prefix blocks plus earlier chunks' pages) and write only
                # this chunk's pages.
                k_pre, v_pre = self.kv.gather_prefix(req.request_id, offset)
            if stamps is not None:
                stamps["t_upload"] = self.tracer.wall()
            tokens = self._tokens(req.prompt_tokens[offset:offset + chunk])
            if stamps is not None:
                stamps["t_launch"] = self.tracer.wall()
            if self.slots is not None:
                logits, cache = self._prefill_slot_chunk(
                    req, offset, tokens, *((k_pre, v_pre) if offset > 0 else (None, None)))
            elif offset > 0 and self.tp_degree > 1:
                logits, cache = tp_mod.sharded_prefill_suffix(
                    self.shard_params, self.cfg, tokens, k_pre[:, None],
                    v_pre[:, None], self.merged_combine)
            elif offset > 0:
                logits, cache = self.model.prefill_suffix(
                    self.params, {"tokens": tokens}, k_pre[:, None], v_pre[:, None])
            elif self.tp_degree > 1:
                logits, cache = tp_mod.sharded_prefill(
                    self.shard_params, self.cfg, tokens, self.merged_combine)
            else:
                logits, cache = self.model.prefill(self.params, {"tokens": tokens})
            if stamps is not None:
                stamps["t_write"] = self.tracer.wall()
            if self.paged:
                self.kv.write_prefill(req.request_id, cache["k"][:, 0],
                                      cache["v"][:, 0], chunk, start=offset)
            else:
                self.states[req.request_id] = cache
            if offset > 0 and offset == cached:
                self.prefix_hits += 1
                self.prefix_tokens_reused += cached
            if final:
                if stamps is not None:
                    stamps["t_readback"] = self.tracer.wall()
                # only the last chunk's last position predicts the next token;
                # a recovery prefill (output_tokens non-empty) keeps its token
                if not req.output_tokens:
                    req.output_tokens.append(int(torch.argmax(logits[0])))
            self.prefill_tokens_computed += chunk
            if stamps is not None:
                self.tracer.emit(
                    req.request_id, "prefill_chunk",
                    start_cycle=now, end_cycle=now,
                    start_wall_s=chunk_wall, end_wall_s=time.monotonic(),
                    node_id=self.node_id,
                    attrs={"offset": offset, "tokens": chunk,
                           "prompt_len": req.prompt_len, "final": final, **stamps})
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
        """One decode step for the running batch; returns finished requests.

        Traced, the step is one ``decode_step`` span (trace_id -1: the step
        belongs to no one request) whose attrs count its real lanes
        (``batch``), the lanes it ran (``lanes``) and the cached tokens its
        real lanes attend (``context_tokens``) and how it ran (``graph``:
        ``"replay"``, ``"capture"`` or ``"eager"``), and with state slots
        the bytes of state its real lanes read and write (``state_bytes``);
        the paged-kernel step adds its block-table width and the phase
        stamps ``t_upload``,
        ``t_launch``, ``t_readback`` and ``t_post``, which with the span's
        start and end cut it into prep, upload, launch, readback and post.
        A graph's step uploads into pinned memory, and its launch is the
        inputs' copies and the replay. Untraced, the step reads no clock."""
        batch = decision.decode_batch
        if not batch:
            return []
        attrs = None
        if self.tracer is not None:
            start = self.tracer.wall()
            attrs = {"batch": len(batch), "lanes": len(batch),
                     "context_tokens": sum(r.total_len - 1 for r in batch),
                     "graph": "eager"}
            if self.slots is not None:
                attrs["state_bytes"] = 2 * len(batch) * self.slots.slot_bytes
        self._step_attrs = attrs        # read by _decode_paged_kernel, this call only
        try:
            decoded = self._decode_paged(batch) if self.paged else self._decode_state(batch)
        finally:
            self._step_attrs = None
        finished: List[Request] = []
        for req in batch:
            last = req.output_tokens[-1]
            eos = req.sampling.eos_token_id
            if req.num_output >= req.sampling.max_new_tokens or (eos is not None and last == eos):
                finished.append(req)
                self.drop_state(req.request_id)
                self.scheduler.decode_finished(req)
        # bandwidth pressure = fraction of the admitted batch that decoded
        self.scheduler.last_bandwidth_util = decoded / max(1, len(batch))
        if attrs is not None:
            self.tracer.emit(-1, "decode_step", start_wall_s=start,
                             end_wall_s=self.tracer.wall(), node_id=self.node_id,
                             attrs=attrs)
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
        instead of aiming at block 0. With state slots a pad lane instead
        reads and writes the scratch slot and appends into the scratch
        block at length 0: a real lane's slot and pages see only its own
        lane. A traced step's attrs take the bucket
        and the phase stamps. An engine with ``graphs`` stages the inputs
        in its bucket's pinned buffers and replays (or first captures) the
        bucket's graph instead of calling ``decode_paged``.
        """
        attrs = self._step_attrs
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
        arrays = (tok_arr, bt, len_arr)
        step = self.model.decode_paged
        if self.slots is not None:
            bt[b:] = 0
            bt[b:, 0] = self.kv.spec.num_blocks - 1
            len_arr[b:] = 0
            slot_arr = np.full((bp,), self.slots.scratch, np.int32)
            slot_arr[:b] = [self.slots.slot_of(r.request_id) for r in batch]
            arrays += (slot_arr,)
            step = self._slot_step
        self._decode_cache_keys.add((bp, wp))
        dev, graphs = self.device, self.graphs
        # decode_dispatches counts host-issued step calls: this branch makes
        # exactly ONE (the argmax below is a host read of its output).
        if attrs is not None:
            attrs.update(lanes=bp, width=wp, t_upload=self.tracer.wall())
        if graphs is not None:
            bucket = graphs.stage(*arrays)
        else:
            inputs = [torch.from_numpy(a).to(dev) for a in arrays]
        if attrs is not None:
            attrs["t_launch"] = self.tracer.wall()
        if graphs is not None:
            logits, how = graphs.run(bucket, step, self.params, self.kv.pool)
            if attrs is not None:
                attrs["graph"] = how
        elif self.tp_degree > 1:
            logits, _ = tp_mod.sharded_decode_step_paged(
                self.shard_params, self.cfg, inputs[0], self.kv.pools, *inputs[1:],
                self.merged_combine)
        else:
            logits, _ = step(self.params, inputs[0], self.kv.pool, *inputs[1:])
        self.kv.num_pool_dispatches += 1
        self.decode_steps += 1
        self.decode_dispatches += 1
        if attrs is not None:
            attrs["t_readback"] = self.tracer.wall()
        nxt = torch.argmax(logits[:b], dim=-1).cpu().tolist()
        if attrs is not None:
            attrs["t_post"] = self.tracer.wall()
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

    def _decode_state(self, batch: List[Request]) -> int:
        """One decode per request on its own state (the state caches are
        per-request dicts, not a batched pool)."""
        n = len(batch)
        for r in batch:
            tok = torch.tensor([r.output_tokens[-1]], dtype=torch.int32, device=self.device)
            logits, self.states[r.request_id] = self.model.decode(
                self.params, tok, self.states[r.request_id])
            r.output_tokens.append(int(torch.argmax(logits[0])))
            r.decode_steps += 1
            # as in the reference: a request is charged every dispatch of
            # the cycles it rode in, and this path runs one per request
            r.decode_dispatches += n
        self.decode_steps += 1
        self.decode_dispatches += n
        return n

    # -- spill path (scheduler hooks) ------------------------------------------------
    def _spill_kv(self, req: Request) -> None:
        """Save a preempted request's KV host-side before its blocks free.

        KV cached at preemption covers positions [0, total_len-1).
        """
        length = req.total_len - 1
        k, v = self.kv.gather_dense(req.request_id, length)
        self.spilled[req.request_id] = (k.cpu(), v.cpu(), length)
        if self.slots is not None and self.slots.owns(req.request_id):
            self.spilled_state[req.request_id] = self.slots.save(req.request_id)

    def _restore_kv(self, req: Request) -> None:
        """Refill fresh blocks with the saved KV when a swap resumes."""
        entry = self.spilled.pop(req.request_id, None)
        if entry is None:
            return   # nothing was spilled (e.g. prefill-side swap, no KV yet)
        k, v, length = entry
        self.kv.write_prefill(req.request_id, k.to(self.device), v.to(self.device),
                              length)
        row = self.spilled_state.pop(req.request_id, None)
        if row is not None:         # its slot was taken by the scheduler's gate
            self.slots.load(req.request_id, row)

    # -- transfer hooks (TransferBackend ports; see core/transfer.py) -------------------
    def export_state(self, req: Request):
        """State-path transfer payload (shipped whole, one segment)."""
        return self.export_state_by_id(req.request_id)

    def import_state(self, req: Request, state) -> None:
        self.import_state_by_id(req.request_id, state)

    def export_state_by_id(self, request_id: int):
        return self.states.pop(request_id)

    def import_state_by_id(self, request_id: int, state) -> None:
        self.states[request_id] = state

    def register_transfer_in(self, req: Request, num_tokens: int) -> List[int]:
        """Destination-side block registration ahead of a paged transfer."""
        return self.scheduler.bm.register(req.request_id, num_tokens)

    # -- lifecycle -----------------------------------------------------------------------
    def release(self, req: Request) -> bool:
        """Drop every trace of a request from this node (cancel path): its
        blocks, its place in every scheduler queue and any state-path state.
        Returns True if anything was released."""
        removed = self.scheduler.remove_request(req)
        if self.states.pop(req.request_id, None) is not None:
            removed = True
        return removed

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
