"""The paged decode step replayed from CUDA graphs, one graph per (lanes,
width) bucket: the port's counterpart of the reference's jit cache
(``repro/serving/engine.py``), which compiles the step once per bucket.

``NodeEngine`` pads every paged step to a power-of-two bucket of lanes and
block-table width. An engine whose step can be captured (a CUDA device,
``tp_degree == 1``, the paged kernel path, and a forward with static shapes:
``Model.decode_paged_static``) keeps a :class:`DecodeGraphs`, which holds for
each bucket the step's inputs (tokens, block tables, lengths, and the
state slots' ids of a family that has them) in device buffers fed from
pinned host buffers, and:

* at the bucket's first sight, runs the step eagerly on those buffers (the
  real step, and the warm-up a capture needs), then captures
  ``Model.decode_paged`` on them: the hand-written K3 and K1 launches, the
  matmuls and the elementwise ops, into one graph memory pool that every
  bucket shares;
* at every later sight, copies the inputs in asynchronously and replays the
  graph, which enqueues the whole forward in one call. A graph replays
  only with the step function, the parameters and the pool it captured
  (the engine never rebinds them; a checkpoint restore writes the pool in
  place), and refuses any other.

Replays run one at a time on the caller's stream, and the engine reads each
step's logits back before the next step, so the buckets can share one pool.
K3's tickets (``kernels.ticket_counters``, one buffer per stream) for the
capture stream are allocated before each capture and held by the bucket, so
no graph outlives the buffer it captured. The kernel wrappers count the
calls the host makes: the eager step's and the capture's, never a
replay's. A replay's kernels show in the device's own records
(torch.profiler), each one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ticket_counters


@dataclasses.dataclass
class _Bucket:
    """One (lanes, width) bucket: its inputs, and its graph once captured."""
    host: Tuple[np.ndarray, ...]           # numpy views of the pinned buffers
    pinned: Tuple[torch.Tensor, ...]       # tokens (lanes,), tables (lanes, width), lengths, ...
    dev: Tuple[torch.Tensor, ...]          # the same on the device: the graph's inputs
    graph: Optional[torch.cuda.CUDAGraph] = None
    logits: Optional[torch.Tensor] = None  # the graph's output (lanes, vocab) fp32
    captured: tuple = ()                   # (step function, params, pool) it read
    tickets: Optional[torch.Tensor] = None


class DecodeGraphs:
    """The paged step's CUDA graphs of one engine, by (lanes, width)."""

    def __init__(self, device: torch.device, tickets_per_lane: int):
        self.device = device
        self.tickets_per_lane = tickets_per_lane
        self._mempool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        self._buckets: Dict[Tuple[int, int], _Bucket] = {}
        self.captures = 0       # graphs captured, one a bucket
        self.replays = 0        # steps served by a replay

    def stage(self, *arrays: np.ndarray) -> _Bucket:
        """Write one step's padded inputs (tokens, tables, lengths, then any
        further per-lane input) into the pinned host buffers of their
        bucket (the tables' shape). The previous step's read-back
        synchronised the stream, so no copy from these buffers is pending."""
        key = arrays[1].shape
        b = self._buckets.get(key)
        if b is None:
            pinned = tuple(torch.empty(a.shape, dtype=torch.int32, pin_memory=True)
                           for a in arrays)
            b = self._buckets[key] = _Bucket(
                host=tuple(t.numpy() for t in pinned), pinned=pinned,
                dev=tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                          for t in pinned))
        for buf, arr in zip(b.host, arrays):
            buf[...] = arr
        return b

    def run(self, b: _Bucket, decode: Callable, params, pool: torch.Tensor
            ) -> Tuple[torch.Tensor, str]:
        """The step on ``b``'s inputs: ``(logits, how)``, ``how`` being
        ``"replay"``, or ``"capture"`` where the step ran eagerly and the
        bucket's graph was captured after it. The pool is updated in place
        either way. Raises where ``decode``, ``params`` or ``pool`` is not
        the object the bucket's graph captured."""
        if b.graph is not None and not all(
                x is y for x, y in zip(b.captured, (decode, params, pool))):
            raise RuntimeError(f"decode graph {tuple(b.dev[1].shape)}: the step function, "
                               "parameters or pool differ from those it captured")
        for dst, src in zip(b.dev, b.pinned):
            dst.copy_(src, non_blocking=True)
        if b.graph is not None:
            b.graph.replay()
            self.replays += 1
            return b.logits, "replay"
        tokens, *rest = b.dev
        logits, _ = decode(params, tokens, pool, *rest)
        self._capture(b, decode, params, pool)
        return logits, "capture"

    def _capture(self, b: _Bucket, decode: Callable, params, pool: torch.Tensor) -> None:
        tokens, *rest = b.dev
        b.tickets = ticket_counters(pool.device, self._stream,
                                    tokens.shape[0] * self.tickets_per_lane)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._mempool)
            try:
                logits, _ = decode(params, tokens, pool, *rest)
            finally:
                graph.capture_end()
        b.graph, b.logits, b.captured = graph, logits, (decode, params, pool)
        self.captures += 1
