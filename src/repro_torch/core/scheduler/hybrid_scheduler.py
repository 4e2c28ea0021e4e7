"""Per-node hybrid scheduler (paper §3.4).

Each node runs BOTH a prefill scheduler and a decode scheduler, "like vLLM's
scheduler, each one has separate running, waiting, swapped, and pending
queues ... They share a block manager with the hybrid scheduler. The hybrid
scheduler manages the inference process by coordinating the prefill and
decode schedulers. During each scheduling cycle, it can prioritize
sub-schedulers based on the global controller's instructions. By default,
prefill has priority".

This module is pure control plane: ``schedule()`` emits a
:class:`ScheduleDecision` that the real engine (``serving/engine.py``) or the
discrete-event simulator (``sim/cluster_sim.py``) executes. That split lets
the same scheduler logic drive CPU-scale real inference *and* cluster-scale
simulation — and makes Alg. 1 directly unit-testable.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.core.block_manager import BlockManager
from repro_torch.core.scheduler.metrics import NodeStatus, SlidingWindow
from repro_torch.serving.request import Request, RequestState


@dataclasses.dataclass
class ScheduleDecision:
    """What the node should run this cycle."""

    kind: str                                  # "prefill" | "decode" | "idle"
    prefill_batch: List[Request] = dataclasses.field(default_factory=list)
    prefill_chunks: Dict[int, int] = dataclasses.field(default_factory=dict)  # rid -> tokens this cycle
    decode_batch: List[Request] = dataclasses.field(default_factory=list)
    preempted: List[Request] = dataclasses.field(default_factory=list)

    @property
    def num_prefill_tokens(self) -> int:
        return sum(self.prefill_chunks.get(r.request_id, r.prompt_len) for r in self.prefill_batch)


class SubScheduler:
    """One role's queue set (prefill or decode)."""

    def __init__(self, role: str):
        self.role = role
        self.waiting: Deque[Request] = collections.deque()
        self.running: List[Request] = []
        self.swapped: Deque[Request] = collections.deque()
        self.sending: Deque[Request] = collections.deque()   # FlowKV's new queue

    def queue_lengths(self) -> Dict[str, int]:
        return {
            "running": len(self.running),
            "waiting": len(self.waiting),
            "swapped": len(self.swapped),
            "sending": len(self.sending),
        }

    def drain_all(self) -> List[Request]:
        out = list(self.waiting) + list(self.running) + list(self.swapped) + list(self.sending)
        self.waiting.clear(); self.running.clear(); self.swapped.clear(); self.sending.clear()
        return out


class HybridScheduler:
    """Coordinates a node's prefill + decode sub-schedulers over one BlockManager."""

    def __init__(self, node_id: int, block_manager: BlockManager,
                 max_batch_tokens: int = 8192, max_running: int = 64,
                 chunked_prefill: bool = True, window: int = 8,
                 prefill_chunk_tokens: Optional[int] = None):
        self.node_id = node_id
        self.bm = block_manager
        self.max_batch_tokens = max_batch_tokens
        self.max_running = max_running
        self.chunked_prefill = chunked_prefill
        # Sarathi-style per-request chunk cap: no single prompt may claim
        # more than this many tokens per cycle, so a long prompt leaves
        # budget for the short prompts queued behind it instead of hogging
        # the whole cycle (head-of-line blocking). None = budget-only
        # chunking (a request may fill the entire cycle budget).
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.prefill = SubScheduler("prefill")
        self.decode = SubScheduler("decode")
        # Role priority: "prefill" (default), "decode", or "both" when the
        # controller enables hybrid computation during imbalance.
        self.priority: str = "prefill"
        self._priority_cycles_left: int = 0    # role-switch lease (imbalanced regime)
        self._window = SlidingWindow(window)
        self._progress: Dict[int, int] = {}    # rid -> prefill tokens already computed
        # utilization accounting, updated by the engine/simulator after each cycle
        self.last_compute_util = 0.0
        self.last_bandwidth_util = 0.0
        self.last_token_budget_used = 0.0
        # -- spill hooks (decode memory pressure) ---------------------------------
        # The swapped queue is a REAL spill path: before a preempted request's
        # blocks are freed the engine saves its KV (on_spill), and when the
        # request is re-admitted with fresh blocks the engine restores it
        # (on_resume) — generation continues token-identically. on_discard
        # fires when a request leaves the node for good (cancel / failover)
        # so saved spills never leak. Engines that keep request state outside
        # the pool (state-path pytrees, the simulator) leave these as None.
        self.on_spill: Optional[Callable[[Request], None]] = None
        self.on_resume: Optional[Callable[[Request], None]] = None
        self.on_discard: Optional[Callable[[Request], None]] = None
        # -- prefix-cache hook ------------------------------------------------------
        # Called at waiting-queue admission for requests that hold no blocks
        # yet. The runtime re-validates the request's prompt against the live
        # prefix index for THIS node, re-stamps
        # ``req.num_cached_prefix_tokens`` with the reuse actually available,
        # and returns the shareable full-prefix block ids (possibly empty).
        # When the hook is None the stamp is zeroed at admission: a routing
        # estimate must never bill compute the engine cannot actually skip
        # (the phantom-hit bug this replaces).
        self.resolve_prefix: Optional[Callable[[Request], List[int]]] = None
        # -- per-request state beside the blocks ---------------------------------
        # Called before a request is admitted into prefill or resumed into
        # decode: an engine that holds a state slot per request takes one
        # for it (kept if admission waits anyway) and says False when none
        # is free, so the request waits as it would for blocks. None admits
        # on blocks alone.
        self.can_admit: Optional[Callable[[Request], bool]] = None

    # -- queue entry points (called by the controller / engine) -----------------
    def enqueue_prefill(self, req: Request) -> None:
        req.state = RequestState.WAITING
        req.prefill_node = self.node_id
        self.prefill.waiting.append(req)

    def enqueue_decode(self, req: Request) -> None:
        """Request arrives with its KV already on this node (post-transfer)."""
        req.state = RequestState.DECODING
        req.decode_node = self.node_id
        self.decode.running.append(req)

    def mark_sending(self, req: Request) -> None:
        req.state = RequestState.SENDING
        self.prefill.sending.append(req)

    def sending_done(self, req: Request, free: bool = True) -> None:
        """Transfer left this node. ``free=False`` keeps the blocks (local
        P->D handoff on a role-flexible node: same pool, nothing moved)."""
        try:
            self.prefill.sending.remove(req)
        except ValueError:
            pass
        if free:
            self.bm.free(req.request_id)   # P-side blocks are released after transfer

    def remove_request(self, req: Request) -> bool:
        """Expunge a request from every queue + free its blocks (cancel path)."""
        removed = False
        for sub in (self.prefill, self.decode):
            for q in (sub.waiting, sub.running, sub.swapped, sub.sending):
                try:
                    q.remove(req)
                    removed = True
                except ValueError:
                    pass
        self._progress.pop(req.request_id, None)
        if self.bm.owns(req.request_id):
            self.bm.free(req.request_id)
            removed = True
        if self.on_discard is not None:
            self.on_discard(req)        # drop any saved spill (no leaks)
        return removed

    # -- controller knobs ----------------------------------------------------------
    def set_priority(self, priority: str, cycles: int = 0) -> None:
        """Role switch (imbalanced regime): lease lasts ``cycles`` cycles (0 = sticky)."""
        assert priority in ("prefill", "decode", "both")
        self.priority = priority
        self._priority_cycles_left = cycles

    def _tick_priority_lease(self) -> None:
        if self._priority_cycles_left > 0:
            self._priority_cycles_left -= 1
            if self._priority_cycles_left == 0:
                self.priority = "prefill"   # paper default

    # -- the scheduling cycle ---------------------------------------------------------
    def schedule(self) -> ScheduleDecision:
        """Emit this cycle's decision.

        Chunked mode is CONTINUOUS BATCHING: both roles schedule every
        cycle (priority only orders who draws resources first), so decode
        requests join/leave the running batch between cycles and prefill
        chunks interleave with decode steps instead of the old lockstep
        where one prefill-heavy cycle starved the decode batch. With
        ``chunked_prefill=False`` (the distserve-style baseline) the first
        role to schedule work wins the whole cycle, as before.
        """
        self._tick_priority_lease()
        order = {
            "prefill": ("prefill", "decode"),
            "decode": ("decode", "prefill"),
            "both": ("prefill", "decode"),
        }[self.priority]
        decision = ScheduleDecision(kind="idle")
        for role in order:
            if role == "prefill":
                self._schedule_prefill(decision)
            else:
                self._schedule_decode(decision)
            if decision.kind != "idle" and self.priority != "both" \
                    and not self.chunked_prefill:
                break
        return decision

    def _chunk_cap(self, budget: int) -> int:
        """Per-request token cap for this admission (budget ∧ chunk knob)."""
        if self.prefill_chunk_tokens is None:
            return budget
        return min(budget, self.prefill_chunk_tokens)

    def _align_chunk(self, done: int, chunk: int, prompt_len: int,
                     first: bool = False) -> int:
        """Round a non-final chunk down to a block boundary.

        ``PagedKVCache.write_prefill(start=...)`` requires block-aligned
        suffix starts, so every intermediate chunk boundary must land on a
        multiple of ``block_size`` (``done`` is aligned by induction: prefix
        hits are capped to full blocks and prior chunks were aligned). The
        final chunk may be ragged. Returns 0 when the aligned chunk is
        empty — the request waits for budget next cycle — EXCEPT for the
        cycle's first prefill admission (``first``), which always gets at
        least one block: a token budget below ``block_size`` must throttle
        progress, never starve it (bounded overshoot < block_size tokens).
        """
        if done + chunk >= prompt_len:
            return chunk
        aligned = chunk - (done + chunk) % self.bm.block_size
        if aligned <= 0 and first:
            aligned = min(self.bm.block_size, prompt_len - done)
        return aligned

    def _schedule_prefill(self, decision: ScheduleDecision) -> None:
        budget = self.max_batch_tokens - decision.num_prefill_tokens
        # continue partially-prefilled (chunked) requests first
        for req in list(self.prefill.running):
            if budget <= 0:
                break
            done = self._progress.get(req.request_id, req.num_cached_prefix_tokens)
            remaining = req.prompt_len - done
            if remaining <= 0:
                continue
            chunk = min(remaining, self._chunk_cap(budget)) \
                if self.chunked_prefill else remaining
            if self.chunked_prefill:
                chunk = self._align_chunk(done, chunk, req.prompt_len,
                                          first=not decision.prefill_chunks)
                if chunk <= 0:
                    continue   # sub-block budget left: wait for next cycle
            self._admit_prefill(req, chunk, decision)
            budget -= chunk
        # resume swapped next (vLLM semantics), then admit waiting
        while self.prefill.swapped and budget > 0:
            req = self.prefill.swapped[0]
            done = self._progress.get(req.request_id, 0)
            need = req.prompt_len - done
            chunk = min(need, self._chunk_cap(budget)) \
                if self.chunked_prefill else need
            if chunk < need and not self.chunked_prefill:
                break
            if self.chunked_prefill:
                chunk = self._align_chunk(done, chunk, req.prompt_len,
                                          first=not decision.prefill_chunks)
                if chunk <= 0:
                    break
            # a spilled prefill holds no blocks — re-allocate before admission
            # (was: admitted without blocks, so a resumed spill would crash)
            if not self.bm.owns(req.request_id):
                if self.can_admit is not None and not self.can_admit(req):
                    break
                if not self.bm.can_allocate(req.prompt_len + 1):
                    break
                req.block_ids = self.bm.allocate(req.request_id, req.prompt_len + 1)
                if self.on_resume is not None:
                    self.on_resume(req)
            self.prefill.swapped.popleft()
            self._admit_prefill(req, chunk, decision)
            budget -= chunk
        while self.prefill.waiting and budget > 0 and len(self.prefill.running) < self.max_running:
            req = self.prefill.waiting[0]
            if self.can_admit is not None and not self.can_admit(req):
                break   # no state slot free — leave in waiting
            owned = self.bm.owns(req.request_id)
            prefix_blocks: List[int] = []
            if owned:
                # a remote prefix fetch already landed this request's prefix
                # blocks; top the table up to the full prompt below and keep
                # the fetch-time ``num_cached_prefix_tokens`` stamp
                extra = self.bm.blocks_needed(req.prompt_len + 1) \
                    - len(self.bm.get(req.request_id))
                if extra > self.bm.free_capacity:
                    break   # KV pool full — leave in waiting
            else:
                if self.resolve_prefix is not None:
                    if req.prefix_src_node is not None and \
                            req.prefix_src_node != self.node_id:
                        # pending REMOTE fetch (e.g. destination pool was
                        # momentarily full): the runtime's fetch pass owns
                        # this request — re-stamping it local here would
                        # silently abandon the priced plan. Wait, like any
                        # other blocks-not-ready head-of-line case.
                        break
                    # re-validate the hit against the LIVE index and share
                    # those very blocks; re-stamps num_cached_prefix_tokens
                    prefix_blocks = list(self.resolve_prefix(req))
                else:
                    req.num_cached_prefix_tokens = 0
                if not self.bm.can_allocate(req.prompt_len + 1,
                                            shared_block_ids=prefix_blocks):
                    break   # KV pool full — leave in waiting
            new_tokens = req.prompt_len - req.num_cached_prefix_tokens
            chunk = min(new_tokens, self._chunk_cap(budget)) \
                if self.chunked_prefill else new_tokens
            if chunk < new_tokens and not self.chunked_prefill:
                break
            if self.chunked_prefill:
                chunk = self._align_chunk(req.num_cached_prefix_tokens, chunk,
                                          req.prompt_len,
                                          first=not decision.prefill_chunks)
                if chunk <= 0:
                    break   # sub-block budget: head-of-line waits

            self.prefill.waiting.popleft()
            if owned:
                self.bm.ensure_capacity(req.request_id, req.prompt_len + 1)
                req.block_ids = self.bm.get(req.request_id)
            else:
                # +1: prefill also writes the first generated token's KV;
                # the matched prefix's blocks are SHARED (ref-counted), only
                # the suffix draws fresh blocks
                req.block_ids = self.bm.allocate(req.request_id, req.prompt_len + 1,
                                                 prefix_blocks=prefix_blocks)
            self._admit_prefill(req, chunk, decision)
            budget -= chunk
        self.last_token_budget_used = decision.num_prefill_tokens / max(1, self.max_batch_tokens)

    def _admit_prefill(self, req: Request, chunk: int, decision: ScheduleDecision) -> None:
        req.state = RequestState.PREFILLING
        if req not in self.prefill.running:
            self.prefill.running.append(req)
        decision.prefill_batch.append(req)
        decision.prefill_chunks[req.request_id] = chunk
        decision.kind = "prefill" if decision.kind == "idle" else "mixed"

    def _schedule_decode(self, decision: ScheduleDecision) -> None:
        # resume swapped requests first when KV space frees up (vLLM order)
        while self.decode.swapped:
            req = self.decode.swapped[0]
            if self.can_admit is not None and not self.can_admit(req):
                break
            if not self.bm.can_allocate(req.total_len + 1):
                break
            self.decode.swapped.popleft()
            req.block_ids = self.bm.allocate(req.request_id, req.total_len + 1)
            if self.on_resume is not None:
                self.on_resume(req)     # restore spilled KV into fresh blocks
            req.state = RequestState.DECODING
            self.decode.running.append(req)
        if not self.decode.running:
            return
        batch: List[Request] = []
        for req in list(self.decode.running)[:self.max_running]:
            # Ensure one more token of KV space; preempt (swap) on pressure.
            try:
                self.bm.append_token(req.request_id, req.total_len + 1)
            except Exception:
                self._preempt(req, decision)
                continue
            batch.append(req)
        if batch:
            decision.decode_batch = batch
            decision.kind = "decode" if decision.kind == "idle" else "mixed"

    def _preempt(self, req: Request, decision: ScheduleDecision) -> None:
        """Swap out the youngest decode request under KV pressure.

        on_spill runs BEFORE the blocks are freed so the engine can save the
        request's KV off-pool; _schedule_decode's resume loop restores it
        after re-allocation (on_resume)."""
        self.decode.running.remove(req)
        if self.on_spill is not None:
            self.on_spill(req)
        self.bm.free(req.request_id)
        req.state = RequestState.SWAPPED
        req.block_ids = []
        self.decode.swapped.append(req)
        decision.preempted.append(req)

    # -- progress queries (engine + admission estimator) --------------------------------
    def prefill_tokens_done(self, req: Request) -> int:
        """Prompt tokens already resident for ``req`` (cached prefix +
        completed chunks) — the suffix offset the engine's next chunk
        executes from."""
        return self._progress.get(req.request_id, req.num_cached_prefix_tokens)

    def prefill_backlog_tokens(self) -> List[int]:
        """Per-request REMAINING prefill tokens queued on this node (running
        continuations first, then swapped, then waiting). The admission
        gate prices these as interleaved chunks, not whole prompts."""
        out: List[int] = []
        for req in self.prefill.running:
            rem = req.prompt_len - self.prefill_tokens_done(req)
            if rem > 0:
                out.append(rem)
        for req in self.prefill.swapped:
            out.append(req.prompt_len - self._progress.get(req.request_id, 0))
        for req in self.prefill.waiting:
            out.append(req.prompt_len - req.num_cached_prefix_tokens)
        return out

    # -- completion callbacks (engine/simulator) ---------------------------------------
    def prefill_progressed(self, req: Request, tokens: int) -> bool:
        """Record chunk completion; True when the whole prompt is prefitted."""
        done = self._progress.get(req.request_id, req.num_cached_prefix_tokens) + tokens
        self._progress[req.request_id] = done
        if done >= req.prompt_len:
            self.prefill.running.remove(req)
            self._progress.pop(req.request_id, None)
            return True
        # not finished: chunked prefill keeps it in running for the next cycle
        return False

    def decode_finished(self, req: Request) -> None:
        self.decode.running.remove(req)
        self.bm.free(req.request_id)
        req.state = RequestState.FINISHED

    # -- status sampling -----------------------------------------------------------------
    def sample_status(self) -> NodeStatus:
        p, d = self.prefill.queue_lengths(), self.decode.queue_lengths()
        status = NodeStatus(
            running_prefill=p["running"], waiting_prefill=p["waiting"],
            swapped_prefill=p["swapped"], sending_prefill=p["sending"],
            running_decode=d["running"], waiting_decode=d["waiting"],
            swapped_decode=d["swapped"], sending_decode=d["sending"],
            token_budget_used=self.last_token_budget_used,
            kv_utilization=self.bm.utilization,
            compute_utilization=self.last_compute_util,
            bandwidth_utilization=self.last_bandwidth_util,
        )
        self._window.push(status)
        return status

    def smoothed_status(self) -> NodeStatus:
        return self._window.smoothed()

    # -- fault path -----------------------------------------------------------------------
    def drain_for_failure(self) -> List[Request]:
        """Node died: return every live request for controller requeue."""
        reqs = self.prefill.drain_all() + self.decode.drain_all()
        for r in reqs:
            if self.bm.owns(r.request_id):
                self.bm.free(r.request_id)
            if self.on_discard is not None:
                self.on_discard(r)      # spilled KV dies with the node
            r.reset_for_retry()
        self._progress.clear()
        return reqs
