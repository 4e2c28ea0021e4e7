"""FlowKV serving facade: streaming request handles over the PD cluster.

This is the front door for the disaggregated runtime. Instead of the batch
``PDCluster.run()`` loop (kept as a compatibility wrapper), callers submit
requests one at a time and get back a :class:`RequestHandle`:

.. code-block:: python

    client = FlowKVClient(cfg, params, num_prefill=1, num_decode=1)
    handle = client.submit(prompt_tokens, SamplingParams(max_new_tokens=16))
    for tok in handle.tokens():        # streams per cluster cycle
        print(tok)
    print(handle.stats())              # queue/prefill/transfer/decode split

Handles support incremental streaming (``tokens()``), blocking collection
(``result()``), mid-flight ``cancel()`` (frees KV blocks on every node the
request touched), and per-request timing stats. The client drives the
cluster clock: each ``step()`` is one cluster cycle, and iterating a handle
steps the cluster on demand, so several interleaved streams advance each
other — continuous arrival works by just calling ``submit`` between
iterations.

Node lifecycle is exposed too: ``client.set_role(node_id, "decode")`` flips
a node P<->D mid-run (see ``GlobalController.set_role``), and constructing
with ``role_flip=True`` lets the load-aware scheduler do that flip itself
under computational imbalance.

Overload: constructing with ``admission=AdmissionPolicy(...)`` arms the
controller's admission gate — under sustained overload a submit may come
back DEFERRED (parked controller-side, admitted as load drains) or
terminal REJECTED, with ``handle.rejected`` / ``handle.retry_after``
telling the client when to back off and resubmit (``examples/overload.py``,
``docs/scheduling.md``).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Union

from repro_torch.models.common import ModelConfig
from repro_torch.serving.cluster import PDCluster
from repro_torch.serving.request import Request, RequestState, SamplingParams

# FAILED is deliberately NOT terminal: a failed request sits in the
# controller's retry queue and will be rerouted (token-exact recovery), so
# streaming handles keep driving the cluster through a failover instead of
# ending the stream mid-retry.
TERMINAL_STATES = (RequestState.FINISHED, RequestState.CANCELLED,
                   RequestState.REJECTED)


class RequestHandle:
    """One submitted request: stream, await, cancel, inspect."""

    def __init__(self, client: "FlowKVClient", req: Request):
        self._client = client
        self._req = req

    # -- identity / state ------------------------------------------------------
    @property
    def request_id(self) -> int:
        return self._req.request_id

    @property
    def request(self) -> Request:
        return self._req

    @property
    def state(self) -> RequestState:
        return self._req.state

    @property
    def done(self) -> bool:
        return self._req.state in TERMINAL_STATES

    @property
    def cancelled(self) -> bool:
        return self._req.state is RequestState.CANCELLED

    @property
    def rejected(self) -> bool:
        """True when the admission gate early-rejected this request (overload).

        Check :attr:`retry_after` for the controller's back-off hint and
        resubmit the prompt later — see ``examples/overload.py``.
        """
        return self._req.state is RequestState.REJECTED

    @property
    def retry_after(self) -> Optional[float]:
        """Back-off hint (seconds) set when deferred or rejected."""
        return self._req.retry_after

    # -- streaming -------------------------------------------------------------
    def tokens(self, max_cycles: int = 10_000) -> Iterator[int]:
        """Incremental token stream, fed per cluster cycle.

        Yields every output token exactly once, in order, stepping the
        cluster whenever no new token is buffered yet. Ends when the request
        finishes or is cancelled; raises TimeoutError after ``max_cycles``
        cluster cycles without completion (stuck cluster).
        """
        emitted = 0
        cycles = 0
        while True:
            out = self._req.output_tokens
            while emitted < len(out):
                yield out[emitted]
                emitted += 1
            if self.done:
                return
            if cycles >= max_cycles:
                raise TimeoutError(
                    f"request {self.request_id} incomplete after {max_cycles} cycles")
            self._client.step()
            cycles += 1

    def result(self, max_cycles: int = 10_000) -> List[int]:
        """Block (drive the cluster) until finished; return all output tokens."""
        for _ in self.tokens(max_cycles=max_cycles):
            pass
        return list(self._req.output_tokens)

    # -- control ----------------------------------------------------------------
    def cancel(self) -> bool:
        """Abort the request and free its KV blocks / state on every node."""
        return self._client.cluster.cancel(self._req)

    # -- observability ------------------------------------------------------------
    def stats(self) -> Dict[str, Optional[float]]:
        """Per-request timing breakdown in cluster cycles:
        queue -> prefill -> transfer -> decode, plus ttft/e2e and the
        data-plane counters — transfer ``num_calls`` (transport calls
        priced) and ``num_dispatches`` (fused kernel dispatches; 1 per
        plan), and decode ``decode_steps`` / ``decode_dispatches`` (device
        dispatches issued by the decode cycles this request rode in; equal
        on the zero-gather path, O(batch) apart on the dense oracle)."""
        d = self._req.timing_breakdown()
        d.update({
            "state": self._req.state.value,
            "num_output_tokens": self._req.num_output,
            "prefill_node": self._req.prefill_node,
            "decode_node": self._req.decode_node,
            "decode_steps": self._req.decode_steps,
            "decode_dispatches": self._req.decode_dispatches,
            # prefix reuse: prompt tokens the engine did NOT recompute, and
            # the fused dispatches a remote prefix fetch cost (0 = local hit
            # or cold prefill)
            "num_cached_prefix_tokens": self._req.num_cached_prefix_tokens,
            "prefix_fetch_dispatches": self._req.prefix_fetch_dispatches,
            "retries": self._req.retries,
            "retry_after_s": self._req.retry_after,
            "reject_reason": self._req.reject_reason,
            # fault tolerance: did this request survive a failover, how many
            # transfer attempts were retried, how many already-emitted tokens
            # the recovery re-prefilled, and what the failover cost — on the
            # driving clock (recovery_s) and in real seconds (wall).
            "recovered": self._req.recoveries > 0,
            "recoveries": self._req.recoveries,
            "transfer_retries": self._req.transfer_retries,
            "replayed_tokens": self._req.replayed_tokens,
            "recovery_s": self._req.recovery_s,
            "recovery_wall_s": self._req.recovery_wall_s,
        })
        # mesh-parallel topology of the nodes this request ran on: the TP/EP
        # degrees explain the transfer dispatch count (one fused dispatch per
        # overlapping shard pair on a cross-degree P->D hop) and the
        # shard_dispatches the destination pool landed for this request's
        # pages. Degrees default to 1 when a node id is unassigned/unknown.
        engines = self._client.cluster.engines
        for side, nid in (("prefill", self._req.prefill_node),
                          ("decode", self._req.decode_node)):
            eng = engines.get(nid) if nid is not None else None
            d[f"{side}_tp_degree"] = getattr(eng, "tp_degree", 1)
            d[f"{side}_ep_degree"] = getattr(eng, "ep_degree", 1)
        d["shard_dispatches"] = (
            self._req.transfer_dispatches
            if d["prefill_tp_degree"] > 1 or d["decode_tp_degree"] > 1 else 0)
        return d


class FlowKVClient:
    """Front-end facade over a :class:`PDCluster`.

    Either construct a cluster in place (``FlowKVClient(cfg, params, ...)``,
    extra kwargs forwarded to :class:`PDCluster`) or wrap an existing one
    with :meth:`from_cluster`.
    """

    def __init__(self, cfg: Optional[ModelConfig] = None, params=None, *,
                 cluster: Optional[PDCluster] = None, **cluster_kwargs):
        if cluster is None:
            if cfg is None or params is None:
                raise ValueError("need (cfg, params) or an existing cluster=")
            cluster = PDCluster(cfg, params, **cluster_kwargs)
        elif cluster_kwargs or cfg is not None or params is not None:
            raise ValueError(
                "cluster= is mutually exclusive with cfg/params/cluster kwargs")
        self.cluster = cluster
        self.handles: Dict[int, RequestHandle] = {}

    @classmethod
    def from_cluster(cls, cluster: PDCluster) -> "FlowKVClient":
        return cls(cluster=cluster)

    # -- request entry -----------------------------------------------------------
    def submit(self, prompt: Union[Sequence[int], Request],
               sampling: Optional[SamplingParams] = None) -> RequestHandle:
        """Submit a prompt (token ids) or a pre-built Request; route it now.

        Arrival is stamped at submission (the cluster clock), so per-request
        queue/ttft/e2e stats measure from when the system first saw it.
        """
        if isinstance(prompt, Request):
            req = prompt
            req.arrival_time = self.cluster.clock
        else:
            req = Request(prompt_tokens=list(prompt),
                          sampling=sampling or SamplingParams(),
                          arrival_time=self.cluster.clock)
        self.cluster.submit(req)
        handle = RequestHandle(self, req)
        self._prune()   # long-lived clients: drop terminal handles we track
        self.handles[req.request_id] = handle
        return handle

    # -- clock ----------------------------------------------------------------------
    def step(self) -> None:
        """Advance the cluster one cycle (all nodes + controller + transfers)."""
        self.cluster.step()

    def drain(self, max_cycles: int = 10_000) -> List[RequestHandle]:
        """Step until every tracked request reaches a terminal state."""
        tracked = list(self.handles.values())
        pending = [h for h in tracked if not h.done]
        for _ in range(max_cycles):
            if not pending:
                break
            self.step()
            pending = [h for h in pending if not h.done]
        self._prune()
        return tracked

    def _prune(self) -> None:
        """Stop tracking terminal requests (callers keep their own handles)."""
        done = [rid for rid, h in self.handles.items() if h.done]
        for rid in done:
            del self.handles[rid]

    # -- node lifecycle ---------------------------------------------------------------
    def set_role(self, node_id: int, role: str) -> bool:
        """Flip a node prefill<->decode mid-run."""
        return self.cluster.set_role(node_id, role)

    # -- observability -----------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return self.cluster.stats()

    @property
    def controller(self):
        return self.cluster.controller
