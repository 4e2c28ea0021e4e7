"""FLOP and byte counts of a step, op by op. Counterpart of the reference's
``repro/launch/hlo_flops.py``.

The reference compiles a step and parses its optimized HLO text: FLOPs of
every ``dot`` and convolution, operand + result bytes of every top-level op
(fusion internals excluded: the optimistic model of XLA's
``HloCostAnalysis``), with ``while`` bodies multiplied by the trip counts it
parses. PyTorch runs eagerly and has no HLO to parse. Here the step itself
runs, usually on ``meta`` tensors (shapes and dtypes only: nothing is
computed or allocated), under :class:`OpCounter`, a ``TorchDispatchMode``
that sees every aten op:

* **flops**: the formulas registered in ``torch.utils.flop_counter``
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, the fused
  attention ops), the ops the reference counts too; every other op adds 0.
* **bytes**: operand bytes plus result bytes of every op, each tensor's
  distinct elements once (a broadcast operand counts its unexpanded
  elements), skipping views, aliases and the ops that only allocate or read
  metadata. An in-place scatter (``index_put_``, ``copy_``, ...) counts
  its other operands read and its values written, a fill its ``self``
  written, as XLA counts an in-place dynamic-update-slice. Eager PyTorch
  fuses nothing, so this is the traffic of the program as it runs, the
  same optimistic model as the reference's: no re-reads, no cache.
* **peak_bytes**: the live set of the storages the step created, tracked op
  by op and freed as their storages die; its maximum is the step's
  temporary memory beyond its inputs.

Loops need no trip counts to be parsed: eager tracing runs every iteration,
so ``unknown_trip_counts`` is always 0. A loop whose iterations all have
one shape may still run once on ``meta``: ``obs/counting.trips`` runs its
body once and counts it ``n`` times, the reference's multiplication of a
``while`` body by its trip count.

The port's hand-written kernels (K1, K3, K4) have no aten op to count. On
``meta`` tensors their wrappers allocate the output and report the
kernel's own work through ``obs/counting.report``, which adds it to every
active counter.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.obs.counting import CountingMode

aten = torch.ops.aten

# Ops that alias or read metadata: they move no bytes and make no storage.
_ALIASES = frozenset((
    aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view, aten.sym_size,
    aten.sym_stride, aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
    aten.set_, aten.resize_))
# Ops that only allocate: they move no bytes.
_ALLOCS = frozenset((aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
                     aten.new_empty_strided))
# In-place ops that write part of ``self`` without reading it: they read
# their other operands and write as many bytes as the largest of them (the
# values), not all of ``self`` (a decode step's cache write).
_SCATTERS = frozenset((
    aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.index_add_,
    aten.scatter_, aten.scatter_add_, aten.masked_scatter_, aten.copy_))
# In-place ops that write all of ``self`` without reading it.
_FILLS = frozenset((aten.zero_, aten.fill_))


@dataclasses.dataclass
class OpCounts:
    """What one counted run did: ``flops`` and ``bytes`` (every op and every
    reported kernel), ``flops_by_op`` (aten op or kernel name -> FLOPs),
    ``ops`` (aten ops seen), ``peak_bytes`` (the live set's maximum) and
    ``kernels`` (kernel name -> launches, flops, bytes)."""
    flops: int = 0
    bytes: int = 0
    ops: int = 0
    peak_bytes: int = 0
    flops_by_op: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    bytes_by_op: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    unknown_trip_counts: int = 0       # eager tracing runs every loop iteration

    def as_dict(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "peak_bytes": self.peak_bytes,
                "flops_by_op": dict(sorted(self.flops_by_op.items())),
                "bytes_by_op": dict(sorted(self.bytes_by_op.items())),
                "kernels": self.kernels, "unknown_trip_counts": self.unknown_trip_counts}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: a dim of stride 0 (a broadcast)
    counts once."""
    st = t.stride()
    if not st or min(st) != 0:
        return t.numel() * t.element_size()
    return math.prod(s for s, d in zip(t.shape, st) if d != 0) * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments or
    results)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


@functools.lru_cache(maxsize=None)
def _kind(func) -> str:
    """How an op moves bytes: "alias" (a view, an alias or a metadata op:
    none), "alloc" (allocates: none), "scatter", "fill", "inplace" (writes
    an argument) or "op" (a new result)."""
    packet = func._overloadpacket
    returns = [r.alias_info for r in func._schema.returns]
    if packet in _ALIASES or any(a is not None and not a.is_write for a in returns):
        return "alias"
    if packet in _ALLOCS:
        return "alloc"
    if packet in _SCATTERS:
        return "scatter"
    if packet in _FILLS:
        return "fill"
    return "inplace" if any(a is not None for a in returns) else "op"


class OpCounter(CountingMode):
    """Counts every aten op run under it into ``self.counts`` (see the
    module docstring). Use as a context manager, or through :func:`count`."""

    def __init__(self):
        super().__init__()
        self.counts = OpCounts()
        self._live: Dict[int, int] = {}      # id(storage) -> bytes, storages made here
        self._live_bytes = 0

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, results) -> None:
        """Add the storages of a new op's results to the live set."""
        for t in results:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self._live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.counts.peak_bytes = max(self.counts.peak_bytes, self._live_bytes)

    def add(self, name: str, flops: int, nbytes: int) -> None:
        c = self.counts
        flops, nbytes = flops * self.scale, nbytes * self.scale
        c.flops += flops
        c.bytes += nbytes
        if flops:
            c.flops_by_op[name] += flops
        if nbytes:
            c.bytes_by_op[name] += nbytes

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        self.add(name, flops, nbytes)
        k = self.counts.kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
        k["launches"] += self.scale
        k["flops"] += flops * self.scale
        k["bytes"] += nbytes * self.scale

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counts.ops += self.scale
        kind = _kind(func)
        if kind == "alias":
            return out
        results = _tensors(out)
        if kind == "alloc":
            self._track(results)
            return out
        inputs = _tensors((args, kwargs))
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        if kind == "scatter":
            others = [tensor_bytes(t) for t in inputs[1:]]
            nbytes = sum(others) + max(others, default=0)
        elif kind == "fill":
            nbytes = tensor_bytes(inputs[0])
        else:
            nbytes = sum(map(tensor_bytes, inputs)) + sum(map(tensor_bytes, results))
        self.add(packet.__name__, flops, nbytes)
        if kind == "op":
            self._track(results)
        return out


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, OpCounts]:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter`; returns
    (its result, the counts)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.counts
