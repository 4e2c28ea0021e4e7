"""Request lifecycle for the PD-disaggregated serving runtime.

FlowKV extends the usual vLLM state machine with a SENDING stage (paper
App. B.2): requests that finished prefill and are waiting for their KV cache
to reach the decode node sit in the sending queue, and the sending-queue
length is one of the load-score features.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional, Sequence

_req_counter = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"          # queued, not yet scheduled for prefill
    PREFILLING = "prefilling"    # running prefill on a P-role scheduler
    SENDING = "sending"          # prefill done; KV cache transfer in flight
    DECODING = "decoding"        # running decode on a D-role scheduler
    SWAPPED = "swapped"          # preempted, KV swapped out
    FINISHED = "finished"
    CANCELLED = "cancelled"      # client cancel; blocks freed on every node
    FAILED = "failed"            # node died; will be requeued by the controller
    REJECTED = "rejected"        # admission gate: overload early-rejection
    #                              (terminal; retry_after hints when to resubmit)

# States that occupy KV blocks on some node.
LIVE_STATES = (RequestState.PREFILLING, RequestState.SENDING,
               RequestState.DECODING, RequestState.SWAPPED)


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 256
    temperature: float = 0.0
    top_k: int = 1
    eos_token_id: Optional[int] = None


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    request_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    arrival_time: float = 0.0

    # --- mutable lifecycle state ---------------------------------------------
    state: RequestState = RequestState.WAITING
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    prefill_node: Optional[int] = None
    decode_node: Optional[int] = None
    block_ids: List[int] = dataclasses.field(default_factory=list)   # on current node
    num_cached_prefix_tokens: int = 0   # prefix-cache hit length (skipped compute)
    # Winning prefix-reuse plan from routing: the node holding the matched
    # blocks (== prefill_node for a local hit, another node for a remote
    # fetch, None for recompute) and the matched block ids on that node.
    # Local hits are RE-validated at admission against the live index;
    # remote plans are executed by the runtime as one fused transfer.
    prefix_src_node: Optional[int] = None
    prefix_block_ids: List[int] = dataclasses.field(default_factory=list)
    # Set when a remote prefix fetch actually ran (its cost shows in stats()).
    prefix_fetch_dispatches: int = 0
    # Memoized prompt digest chain (prompt is immutable): the controller
    # hashes once per request instead of once per probe/retry cycle.
    prefix_chain_cache: Optional[List[bytes]] = None

    # --- timing (set by engine / simulator clocks) ----------------------------
    prefill_start: Optional[float] = None
    prefill_end: Optional[float] = None
    transfer_start: Optional[float] = None
    transfer_end: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    retries: int = 0

    # --- wall-clock timing (time.monotonic(), stamped by the real runtime) -----
    # The fields above run on the driving scheduler clock (cluster CYCLES in
    # PDCluster, simulated seconds in ClusterSim). These parallel stamps are
    # real seconds, so per-phase durations are reportable without the sim's
    # cycle->s conversion. The simulator leaves them None.
    arrival_wall: Optional[float] = None
    prefill_start_wall: Optional[float] = None
    prefill_end_wall: Optional[float] = None
    transfer_start_wall: Optional[float] = None
    transfer_end_wall: Optional[float] = None
    first_token_wall: Optional[float] = None
    finish_wall: Optional[float] = None

    # --- admission gate (set when the controller defers/rejects) ---------------
    retry_after: Optional[float] = None   # hint: resubmit after this many seconds
    reject_reason: Optional[str] = None   # e.g. "predicted_ttft 42.1s > slo 30.0s"
    admission_defers: int = 0             # cycles spent in the deferred queue

    # --- transfer data-plane counters (set when the KV transfer runs) ----------
    transfer_calls: Optional[int] = None        # transport calls priced
    transfer_dispatches: Optional[int] = None   # fused kernel dispatches
    # tokens in the FINAL prefill chunk (== prompt_len when unchunked): the
    # compute window layer-window transfer overlap can hide behind
    last_prefill_chunk_tokens: Optional[int] = None

    # --- decode data-plane counters (accumulated per decode cycle) --------------
    decode_steps: int = 0          # decode cycles this request participated in
    decode_dispatches: int = 0     # device dispatches those cycles issued
    #                                (1/step zero-gather; O(batch)/step oracle)

    # --- fault tolerance (set on failover / transfer retry) ----------------------
    # The prompt length the CLIENT submitted. Recovery rewrites prompt_tokens
    # to prompt + already-emitted tokens (teacher-forced re-prefill), so the
    # original boundary must be remembered the first time that happens.
    client_prompt_len: Optional[int] = None
    # Emitted tokens folded back into the prompt by the last recovery; they
    # are counted once in prompt_len AND once in num_output, so total_len
    # subtracts them out.
    replayed_tokens: int = 0
    transfer_retries: int = 0      # failed/corrupt transfer attempts retried
    recoveries: int = 0            # completed failovers (recovery span emitted)
    recovery_start: Optional[float] = None        # set at failure detection,
    recovery_start_wall: Optional[float] = None   # cleared when work resumes
    recovery_s: float = 0.0                       # accumulated recovery time
    recovery_wall_s: Optional[float] = None

    # -- derived ----------------------------------------------------------------
    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def num_output(self) -> int:
        return len(self.output_tokens)

    @property
    def total_len(self) -> int:
        # replayed tokens live in BOTH prompt_tokens (recovery re-prefill)
        # and output_tokens (exactly-once client delivery): count them once.
        return self.prompt_len + self.num_output - self.replayed_tokens

    def num_blocks(self, block_size: int) -> int:
        return -(-self.total_len // block_size)

    @property
    def done(self) -> bool:
        return self.state is RequestState.FINISHED

    # -- metrics ------------------------------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def tpot(self) -> Optional[float]:
        """Time per output token, excluding the first (paper's TPOT).

        ``first_token_time`` is stamped when prefill emits the first token,
        so in disaggregated runs the first decode interval — and therefore
        TPOT — includes the P->D transfer gap. That is the latency a client
        actually observes between tokens 1 and 2.
        """
        if self.finish_time is None or self.first_token_time is None or self.num_output < 2:
            return None
        return (self.finish_time - self.first_token_time) / (self.num_output - 1)

    def transfer_latency(self) -> Optional[float]:
        if self.transfer_start is None or self.transfer_end is None:
            return None
        return self.transfer_end - self.transfer_start

    def timing_breakdown(self) -> dict:
        """Per-stage timing split (None where the stage hasn't happened):
        queue -> prefill -> transfer -> decode, plus ttft / e2e.

        The unsuffixed entries run on the driving scheduler clock (cycles in
        the real cluster, simulated seconds in the sim); the ``*_wall_s``
        entries are monotonic wall-clock SECONDS stamped by the real runtime
        (None in the simulator)."""
        def span(a: Optional[float], b: Optional[float]) -> Optional[float]:
            return None if a is None or b is None else b - a
        return {
            "queue_s": span(self.arrival_time, self.prefill_start),
            "prefill_s": span(self.prefill_start, self.prefill_end),
            "transfer_s": self.transfer_latency(),
            "decode_s": span(self.transfer_end, self.finish_time),
            "ttft_s": self.ttft(),
            "e2e_s": self.e2e(),
            "queue_wall_s": span(self.arrival_wall, self.prefill_start_wall),
            "prefill_wall_s": span(self.prefill_start_wall,
                                   self.prefill_end_wall),
            "transfer_wall_s": span(self.transfer_start_wall,
                                    self.transfer_end_wall),
            "decode_wall_s": span(self.transfer_end_wall, self.finish_wall),
            "ttft_wall_s": span(self.arrival_wall, self.first_token_wall),
            "e2e_wall_s": span(self.arrival_wall, self.finish_wall),
            "num_calls": self.transfer_calls,
            "num_dispatches": self.transfer_dispatches,
        }

    def clear_prefix_plan(self) -> None:
        """Degrade a routed prefix-reuse plan to recompute (staleness paths:
        source died, blocks freed, fetch impossible). One helper so the
        controller, cluster and simulator can never clear half a plan."""
        self.num_cached_prefix_tokens = 0
        self.prefix_src_node = None
        self.prefix_block_ids = []

    def reset_for_retry(self) -> None:
        """Requeue after a node failure — WITHOUT losing emitted tokens.

        Token-exact recovery: tokens already delivered to the client cannot
        be un-sent, so the retry must regenerate the same continuation. All
        generated tokens except the newest are folded into the prompt
        (teacher-forced re-prefill through the ordinary suffix path); the
        newest token is re-predicted by the recovery prefill's final forward
        (the engine skips the duplicate append) and decode resumes from it.
        ``output_tokens`` is kept verbatim, so the streaming handle's
        emitted-counter delivers each token exactly once across a failover.
        """
        if self.client_prompt_len is None:
            self.client_prompt_len = self.prompt_len
        if self.output_tokens:
            self.prompt_tokens = (self.prompt_tokens[:self.client_prompt_len]
                                  + self.output_tokens[:-1])
            self.replayed_tokens = len(self.output_tokens) - 1
            self.prefix_chain_cache = None    # prompt changed: re-hash
        else:
            self.first_token_time = None
            self.first_token_wall = None
        # FAILED while parked in the retry queue (so a client cancel is
        # distinguishable there); enqueue_prefill flips it back to WAITING.
        self.state = RequestState.FAILED
        self.block_ids = []
        self.prefill_node = None
        self.decode_node = None
        self.clear_prefix_plan()
        self.prefix_fetch_dispatches = 0
        self.prefill_start = self.prefill_end = None
        self.transfer_start = self.transfer_end = None
        self.prefill_start_wall = self.prefill_end_wall = None
        self.transfer_start_wall = self.transfer_end_wall = None
        self.transfer_calls = self.transfer_dispatches = None
        self.decode_steps = self.decode_dispatches = 0
        self.retry_after = None
        self.reject_reason = None
        self.retries += 1


def make_batch(prompts: Sequence[Sequence[int]], arrival_times: Optional[Sequence[float]] = None,
               max_new_tokens: int = 256) -> List[Request]:
    out = []
    for i, p in enumerate(prompts):
        out.append(Request(
            prompt_tokens=list(p),
            sampling=SamplingParams(max_new_tokens=max_new_tokens),
            arrival_time=0.0 if arrival_times is None else float(arrival_times[i]),
        ))
    return out
