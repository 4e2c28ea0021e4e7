"""KV-cache transfer planning and execution.

Three transfer *schedules*, matching the paper's comparison set:

* ``layerwise`` (Splitwise-style baseline): one call per (layer, K/V, block)
  — ``2 * L * n`` calls. Overlappable with compute but call-bound.
* ``blockwise`` (vLLM-disagg-style): per-layer buffers are merged then sent
  — ``2 * L`` calls plus a per-byte merge cost.
* ``flowkv``: FlowKV layout + bidirectional segment alignment — one call per
  aligned run (ideally 1).

The planner produces an exact :class:`TransferPlan` (call count, bytes,
per-run descriptors). Execution is schedule-INDEPENDENT: every plan lowers to
a :class:`DescriptorTable` — int32 arrays of (src block, dst block, layer,
k/v) page descriptors — and the engine runs the whole table as ONE launch of
the K1 gather–scatter kernel (``kernels/kv_gather``, CUDA on a GPU, its plain
PyTorch version on the CPU), in place on the destination pool. Schedules therefore differ only in how
many *transport calls* the cost model prices (``num_calls``), never in Python
loop structure; the dispatch count is 1 per non-empty plan by construction.

On the GPU each descriptor row is one page copy inside the single launch;
the *latency* of the modeled transport (IPC / NCCL) is priced by
``core.costmodel``.

The TransferBackend protocol
----------------------------

Node-to-node request-state movement is dispatched through a small protocol so
runtimes never branch on *how* a model family stores its cache:

.. code-block:: python

    class TransferBackend:
        name: str
        def plan(self, req, src, dst) -> TransferJob: ...
        def execute(self, job, src, dst) -> None: ...
        def price(self, job, profile: TransportProfile) -> float: ...

``plan`` reserves destination capacity and returns a :class:`TransferJob`
(exact call count + byte count, plus any backend-specific payload);
``execute`` moves the data (a no-op for purely simulated backends); ``price``
converts the job into seconds under a :class:`TransportProfile`. ``src`` /
``dst`` are duck-typed *ports*: the real runtime passes
``repro_torch.serving.engine.NodeEngine`` (which exposes ``kv``, ``states``,
``register_transfer_in`` …) and the simulator passes
``repro_torch.sim.cluster_sim.SimNode`` (``bm`` / ``kv_spec`` / ``planner``).

Built-in backends, keyed in the module registry
(:func:`register_backend` / :func:`get_backend`):

* ``paged``  — :class:`PagedBackend`; block-granular plans for any of the
  three schedules above, executed against the paged pools.
* ``state``  — :class:`StateBackend`; whole-pytree movement for the
  ssm / hybrid / encdec families (one logical segment).
* ``paged_state`` — :class:`PagedStateBackend`; the paged plan of a
  family's attention K/V plus one contiguous device copy of the request's
  state slot (granitemoehybrid's Mamba-2 state).
* ``sim``    — :class:`SimulatedBackend`; exact planning + pricing with a
  no-op data plane, for the discrete-event simulator (models e.g. a DCN hop
  without touching device memory). Its call AND dispatch counts come from the
  same descriptor tables the real executor runs.

Third-party backends (RDMA, object-store staging, …) plug in with
``register_backend("myname", MyBackend)`` and are selected per request via
:func:`backend_for_engine` or an explicit ``get_backend`` call.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Literal, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import layout as L
from repro_torch.core.alignment import AlignmentResult, align
from repro_torch.core.costmodel import TransportProfile
from repro_torch.core.segments import Segment, blocks_to_segments
from repro_torch.kernels.kv_gather import kv_transfer, kv_transfer_fine

Schedule = Literal["layerwise", "blockwise", "flowkv"]


# ---------------------------------------------------------------------------
# Shard topology: kv-head sharding of a paged pool (tensor parallelism)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How one pool's kv_heads axis is partitioned over ``tp`` shards.

    Contiguous head ranges: shard ``s`` owns global kv-heads
    ``[s*K/tp, (s+1)*K/tp)`` — the same partition ``spec_for``'s
    ``kv_heads -> model`` rule induces on a mesh, so the transfer plane and
    the compute plane agree on which shard holds which head by construction.
    """

    tp: int = 1
    num_kv_heads: int = 1

    def __post_init__(self):
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.num_kv_heads % self.tp != 0:
            raise ValueError(
                f"kv_heads={self.num_kv_heads} not divisible by tp={self.tp}")

    @property
    def heads_per_shard(self) -> int:
        return self.num_kv_heads // self.tp

    def head_range(self, shard: int) -> Tuple[int, int]:
        """Global [lo, hi) kv-head range owned by ``shard``."""
        lo = shard * self.heads_per_shard
        return lo, lo + self.heads_per_shard


def shard_pairs(src: ShardSpec, dst: ShardSpec
                ) -> List[Tuple[int, int, int, int]]:
    """Overlapping ``(src_shard, dst_shard, head_lo, head_hi)`` pairs.

    A cross-degree transfer moves each kv-head from the source shard that
    holds it to the destination shard that wants it; only pairs whose head
    ranges INTERSECT exchange any bytes, and each such pair moves exactly
    its intersection — so for divisible degrees the pair count is
    ``max(src.tp, dst.tp)`` (``tp_src * tp_dst`` when either side is
    unsharded), and the per-pair byte counts sum exactly to the unsharded
    transfer's bytes.
    """
    if src.num_kv_heads != dst.num_kv_heads:
        raise ValueError(
            f"src/dst pools must cover the same kv-heads; "
            f"got {src.num_kv_heads} vs {dst.num_kv_heads}")
    out: List[Tuple[int, int, int, int]] = []
    for s in range(src.tp):
        s_lo, s_hi = src.head_range(s)
        for d in range(dst.tp):
            d_lo, d_hi = dst.head_range(d)
            lo, hi = max(s_lo, d_lo), min(s_hi, d_hi)
            if lo < hi:
                out.append((s, d, lo, hi))
    return out


def shard_slice_spec(spec: L.KVCacheSpec, shard: ShardSpec) -> L.KVCacheSpec:
    """The per-shard pool spec: same blocks/layers, only its head slice."""
    if spec.num_kv_heads != shard.num_kv_heads:
        raise ValueError(
            f"spec has {spec.num_kv_heads} kv-heads, shard topology expects "
            f"{shard.num_kv_heads}")
    return dataclasses.replace(spec, num_kv_heads=shard.heads_per_shard)


def fine_page_rows(coarse_pages: np.ndarray, block_size: int,
                   local_heads: int, head_lo: int, head_hi: int) -> np.ndarray:
    """Rows of a shard pool's fine ``(-1, head_dim)`` view covered by a
    head-range slice of the given coarse pages.

    ``coarse_pages`` are flat page ids under the shard's per-shard spec
    (``DescriptorTable.page_ids``); each coarse page is ``block_size *
    local_heads`` fine rows, laid out slot-major then head-minor, so the row
    for (page p, slot t, local head h) is ``(p*block_size + t)*local_heads
    + h``. Restricting h to ``[head_lo, head_hi)`` (LOCAL indices) selects
    exactly one shard pair's head intersection — the rows one K1 launch
    moves.
    """
    return _fine_rows_on(torch.device("cpu"), coarse_pages, block_size, local_heads,
                         head_lo, head_hi).numpy()


def _fine_rows_on(device, coarse_pages: np.ndarray, block_size: int, local_heads: int,
                  head_lo: int, head_hi: int) -> torch.Tensor:
    """:func:`fine_page_rows` as an int32 tensor expanded on ``device``:
    only the coarse page ids cross from the host, not the
    block_size * heads times longer row table."""
    p = torch.as_tensor(coarse_pages).to(device).long()
    t = torch.arange(block_size, device=device)
    h = torch.arange(head_lo, head_hi, device=device)
    rows = (p[:, None, None] * block_size + t[None, :, None]) * local_heads + h[None, None, :]
    return rows.reshape(-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class TransferOp:
    """One contiguous-range transfer call (pricing/bookkeeping granularity)."""

    src: Segment              # block-id range on the sender
    dst: Segment              # block-id range on the receiver
    layer: Optional[int]      # None = all layers in one range (FlowKV layout)
    kv: Optional[int]         # None = both K and V; 0/1 for layerwise
    num_bytes: int


@dataclasses.dataclass(frozen=True)
class DescriptorTable:
    """Page-granular lowering of a plan: one row per (block, layer, k/v) page.

    The four row arrays are parallel int32 columns; ``src_block_seq`` /
    ``dst_block_seq`` keep the request's block-pair sequence (one entry per
    block, in plan order) so transport-call counts can be re-derived from the
    very table the executor runs.
    """

    src_block: np.ndarray     # (d,) int32 — sender block id per descriptor
    dst_block: np.ndarray     # (d,) int32
    layer: np.ndarray         # (d,) int32
    kv: np.ndarray            # (d,) int32
    src_block_seq: np.ndarray  # (n,) int32 — block-pair sequence, plan order
    dst_block_seq: np.ndarray  # (n,) int32
    num_layers: int

    def __len__(self) -> int:
        return int(self.src_block.shape[0])

    def page_ids(self, spec: L.KVCacheSpec, side: str) -> np.ndarray:
        """Flattened page ids for one side, honouring that side's layout.

        FLOWKV pools (B, L, 2, H) flatten to page ``block*L*2 + layer*2 + kv``;
        VLLM pools (L, 2, B, H) to ``(layer*2 + kv)*B + block``.
        """
        blocks = self.src_block if side == "src" else self.dst_block
        if spec.layout is L.KVLayout.FLOWKV:
            return (blocks * spec.num_layers + self.layer) * 2 + self.kv
        return (self.layer * 2 + self.kv) * np.int32(spec.num_blocks) + blocks

    def num_calls(self, schedule: Schedule) -> int:
        """Transport calls this table costs under a schedule (paper Table 3)."""
        n = int(self.src_block_seq.shape[0])
        if n == 0:
            return 0
        if schedule == "layerwise":
            return 2 * self.num_layers * n
        if schedule == "blockwise":
            return 2 * self.num_layers
        # flowkv: one call per bidirectionally-aligned run of block pairs —
        # delegated to align() so run detection has a single source of truth
        # shared with the planner's per-run ops/pricing.
        return align(self.src_block_seq.tolist(),
                     self.dst_block_seq.tolist()).num_calls


def _lower_descriptors(schedule: Schedule, num_layers: int,
                       src_blocks: Sequence[int],
                       dst_blocks: Sequence[int],
                       layer_lo: int = 0,
                       layer_hi: Optional[int] = None) -> DescriptorTable:
    """Expand a plan's block lists into its page-descriptor table.

    Row order is schedule-faithful (layerwise/flowkv are block-major, blockwise
    is (layer, k/v)-major) but execution is order-independent: destination
    pages within a plan are disjoint.

    ``layer_lo``/``layer_hi`` restrict the table to the layer window
    ``[lo, hi)`` — the lowering for a layer-window sub-plan (pipelined
    transfer/compute overlap). The default covers every layer, and the
    table's ``num_layers`` is always the count of layers it actually
    carries, so per-schedule call derivations stay window-faithful.
    """
    s = np.asarray(list(src_blocks), np.int32)
    d = np.asarray(list(dst_blocks), np.int32)
    n = s.shape[0]
    lo = layer_lo
    hi = num_layers if layer_hi is None else layer_hi
    Lr = hi - lo
    layers = np.arange(lo, hi, dtype=np.int32)
    lay_inner = np.repeat(layers, 2)                          # (2Lr,) per block
    kv_inner = np.tile(np.arange(2, dtype=np.int32), Lr)
    if schedule == "blockwise":
        src_block = np.tile(s, 2 * Lr)
        dst_block = np.tile(d, 2 * Lr)
        layer = np.repeat(layers, 2 * n)
        kv = np.tile(np.repeat(np.arange(2, dtype=np.int32), n), Lr)
    else:
        src_block = np.repeat(s, 2 * Lr)
        dst_block = np.repeat(d, 2 * Lr)
        layer = np.tile(lay_inner, n)
        kv = np.tile(kv_inner, n)
    return DescriptorTable(src_block=src_block, dst_block=dst_block,
                           layer=layer, kv=kv, src_block_seq=s,
                           dst_block_seq=d, num_layers=Lr)


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    schedule: Schedule
    ops: List[TransferOp]
    total_bytes: int
    num_blocks: int
    num_layers: int
    src_blocks: Tuple[int, ...]
    dst_blocks: Tuple[int, ...]
    # Layer-window sub-plan bounds (transfer/compute overlap): the plan
    # covers layers [layer_lo, layer_hi). Defaults cover every layer — a
    # full plan is the layer_lo=0, layer_hi=None degenerate window, and
    # nothing downstream changes unless split_layer_windows() is used.
    layer_lo: int = 0
    layer_hi: Optional[int] = None
    # Shard topology of each side's pool (None = unsharded). When set, the
    # plan lowers to one fused dispatch per overlapping (src, dst) shard
    # pair; split_layer_windows carries the topology into every sub-plan
    # via dataclasses.replace, so layer-window overlap composes unchanged.
    src_shard: Optional[ShardSpec] = None
    dst_shard: Optional[ShardSpec] = None

    @functools.cached_property
    def _descriptors(self) -> DescriptorTable:
        return _lower_descriptors(self.schedule, self.num_layers,
                                  self.src_blocks, self.dst_blocks,
                                  self.layer_lo, self.layer_hi)

    def to_descriptors(self) -> DescriptorTable:
        """Lower to the page-descriptor table the fused executor consumes."""
        return self._descriptors

    @property
    def layer_span(self) -> Tuple[int, int]:
        """The [lo, hi) layer window this plan carries."""
        return (self.layer_lo,
                self.num_layers if self.layer_hi is None else self.layer_hi)

    @property
    def num_calls(self) -> int:
        """Transport calls priced by the cost model — derived from the SAME
        descriptor table the executor dispatches (not from ``ops``)."""
        return self.to_descriptors().num_calls(self.schedule)

    @property
    def sharded(self) -> bool:
        return self.src_shard is not None or self.dst_shard is not None

    def shard_pair_list(self) -> List[Tuple[int, int, int, int]]:
        """Overlapping shard pairs for this plan (one dispatch each); an
        unsharded side defaults to ShardSpec(tp=1) over the same heads."""
        heads = (self.src_shard or self.dst_shard).num_kv_heads
        return shard_pairs(self.src_shard or ShardSpec(1, heads),
                           self.dst_shard or ShardSpec(1, heads))

    @property
    def num_dispatches(self) -> int:
        """Kernel dispatches to execute this plan: 0 if empty; 1 unsharded;
        one per overlapping (src_shard, dst_shard) pair when sharded."""
        if not len(self.to_descriptors()):
            return 0
        if self.sharded:
            return len(self.shard_pair_list())
        return 1

    def latency(self, profile: TransportProfile) -> float:
        return profile.latency(self.num_calls, self.total_bytes)

    def split_layer_windows(self, window: int) -> List["TransferPlan"]:
        """Slice this plan into per-layer-window sub-plans for pipelined
        transfer/compute overlap (Mooncake-style layerwise KV streaming).

        Each sub-plan covers ``window`` consecutive layers of the SAME
        block pairs and executes as its own fused descriptor-table
        dispatch, so window w can be on the wire while layers >= w*window
        are still prefilling. Bytes partition exactly
        (``sum(sub.total_bytes) == total_bytes``); transport calls are
        counted per window, which is precisely the overlap's cost side —
        more, smaller calls. ``window <= 0`` or >= num_layers (or an empty
        plan) returns ``[self]`` unchanged.
        """
        L = self.num_layers
        if window <= 0 or window >= L or not self.src_blocks:
            return [self]
        out: List[TransferPlan] = []
        for lo in range(0, L, window):
            hi = min(lo + window, L)
            # cumulative-difference split so bytes sum exactly to the total
            bytes_w = (self.total_bytes * hi // L
                       - self.total_bytes * lo // L)
            if self.schedule == "flowkv":
                # flowkv ops are all-layer runs (layer=None): scale per run
                ops_w = [dataclasses.replace(
                    op, num_bytes=op.num_bytes * (hi - lo) // L)
                    for op in self.ops]
            else:
                ops_w = [op for op in self.ops
                         if op.layer is not None and lo <= op.layer < hi]
            out.append(dataclasses.replace(
                self, ops=ops_w, total_bytes=bytes_w,
                layer_lo=lo, layer_hi=hi))
        return out


class TransferPlanner:
    """Builds exact transfer plans for a request's block lists."""

    def __init__(self, spec: L.KVCacheSpec):
        self.spec = spec

    # -- plan builders ---------------------------------------------------------
    def plan(self, schedule: Schedule, src_blocks: Sequence[int],
             dst_blocks: Sequence[int]) -> TransferPlan:
        if schedule == "layerwise":
            return self.plan_layerwise(src_blocks, dst_blocks)
        if schedule == "blockwise":
            return self.plan_blockwise(src_blocks, dst_blocks)
        if schedule == "flowkv":
            return self.plan_flowkv(src_blocks, dst_blocks)
        raise ValueError(f"unknown schedule {schedule!r}")

    def _finish(self, schedule: Schedule, ops: List[TransferOp], total: int,
                num_blocks: int, src_blocks: Sequence[int],
                dst_blocks: Sequence[int]) -> TransferPlan:
        return TransferPlan(schedule, ops, total, num_blocks,
                            self.spec.num_layers,
                            tuple(int(b) for b in src_blocks),
                            tuple(int(b) for b in dst_blocks))

    def plan_layerwise(self, src_blocks: Sequence[int], dst_blocks: Sequence[int]) -> TransferPlan:
        """2 * L calls per block: the per-(layer, k/v, block) baseline."""
        spec = self.spec
        src_blocks, dst_blocks = list(src_blocks), list(dst_blocks)
        per_call = spec.payload * spec.dtype.itemsize
        ops: List[TransferOp] = []
        for s, d in zip(src_blocks, dst_blocks):
            for layer in range(spec.num_layers):
                for kv in (0, 1):
                    ops.append(TransferOp(Segment(int(s), 1), Segment(int(d), 1),
                                          layer=layer, kv=kv, num_bytes=per_call))
        total = per_call * len(ops)
        return self._finish("layerwise", ops, total, len(src_blocks),
                            src_blocks, dst_blocks)

    def plan_blockwise(self, src_blocks: Sequence[int], dst_blocks: Sequence[int]) -> TransferPlan:
        """2 * L calls total: per-layer buffers merged then sent (vLLM-disagg).

        The merge memcpy cost is priced by the ``vllm_merge`` transport
        profile, not counted as calls. An empty block list yields an empty
        plan (no calls, no bytes) — nothing was allocated, nothing moves.
        """
        spec = self.spec
        src_blocks, dst_blocks = list(src_blocks), list(dst_blocks)
        n = len(src_blocks)
        if n == 0:
            return self._finish("blockwise", [], 0, 0, [], [])
        layer_bytes = n * spec.payload * spec.dtype.itemsize
        ops: List[TransferOp] = []
        src_segs = blocks_to_segments(src_blocks)
        dst_segs = blocks_to_segments(dst_blocks)
        # One merged buffer per (layer, k/v); src/dst ranges recorded as the
        # first run for bookkeeping (the buffer itself is staged).
        for layer in range(spec.num_layers):
            for kv in (0, 1):
                ops.append(TransferOp(src_segs[0], dst_segs[0],
                                      layer=layer, kv=kv, num_bytes=layer_bytes))
        return self._finish("blockwise", ops, layer_bytes * len(ops), n,
                            src_blocks, dst_blocks)

    def plan_flowkv(self, src_blocks: Sequence[int], dst_blocks: Sequence[int]) -> TransferPlan:
        """Bidirectional segment alignment over the FlowKV layout."""
        if self.spec.layout is not L.KVLayout.FLOWKV:
            raise ValueError(
                "flowkv schedule requires the FLOWKV (B, L, 2, H) layout; "
                f"got {self.spec.layout}"
            )
        src_blocks, dst_blocks = list(src_blocks), list(dst_blocks)
        result: AlignmentResult = align(src_blocks, dst_blocks)
        ops = [
            TransferOp(run.src, run.dst, layer=None, kv=None,
                       num_bytes=run.length * self.spec.bytes_per_block)
            for run in result.runs
        ]
        total = sum(op.num_bytes for op in ops)
        return self._finish("flowkv", ops, total, result.num_blocks,
                            src_blocks, dst_blocks)


# ---------------------------------------------------------------------------
# Fused executor: one K1 launch per plan
# ---------------------------------------------------------------------------
# Module-wide dispatch counter: every fused-kernel invocation anywhere in the
# process increments this exactly once (tests and benchmarks read it).
_TOTAL_DISPATCHES = 0


def total_dispatches() -> int:
    return _TOTAL_DISPATCHES


def reset_dispatch_counter() -> None:
    global _TOTAL_DISPATCHES
    _TOTAL_DISPATCHES = 0


def _device_pages(page_ids: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(page_ids, dtype=torch.int32).to(device)


class TransferEngine:
    """Executes transfer plans against real device pools.

    Every plan — any schedule, any src/dst layout pairing, any (possibly
    heterogeneous) pool sizes — executes as ONE launch of the K1 kernel: the
    plan lowers to flattened page ids on each side and the kernel moves all
    pages in a single call, in place on the destination pool.
    ``num_dispatches`` counts the engine's kernel invocations.
    """

    def __init__(self, src_spec: L.KVCacheSpec, dst_spec: Optional[L.KVCacheSpec] = None):
        self.src_spec = src_spec
        self.dst_spec = dst_spec or src_spec
        if self.src_spec.bytes_per_block != self.dst_spec.bytes_per_block:
            raise ValueError("src/dst pools must agree on per-block payload")
        if self.src_spec.num_layers != self.dst_spec.num_layers:
            raise ValueError("src/dst pools must agree on layer count")
        if self.src_spec.payload != self.dst_spec.payload:
            raise ValueError("src/dst pools must agree on page payload")
        self.planner = TransferPlanner(src_spec)
        self.num_dispatches = 0

    def plan(self, schedule: Schedule, src_blocks: Sequence[int],
             dst_blocks: Sequence[int]) -> TransferPlan:
        return self.planner.plan(schedule, src_blocks, dst_blocks)

    def execute(self, plan: TransferPlan, src_cache: torch.Tensor,
                dst_cache: torch.Tensor) -> torch.Tensor:
        """Apply a plan in one launch, in place; returns ``dst_cache``."""
        global _TOTAL_DISPATCHES
        table = plan.to_descriptors()
        if len(table) == 0:
            return dst_cache
        # the tables go to the side that launches: dst's device, or src's
        # when dst is a host pool (a demotion to the host tier)
        dev = src_cache.device if dst_cache.device.type == "cpu" else dst_cache.device
        src_pages = _device_pages(table.page_ids(self.src_spec, "src"), dev)
        dst_pages = _device_pages(table.page_ids(self.dst_spec, "dst"), dev)
        self.num_dispatches += 1
        _TOTAL_DISPATCHES += 1
        return kv_transfer(src_cache, dst_cache, src_pages, dst_pages)


class ShardedTransferEngine:
    """Executes plans between two kv-head-sharded pools, possibly of
    DIFFERENT tensor-parallel degrees (e.g. TP=2 prefill -> TP=4 decode).

    Each side's pool is a list of per-shard tensors (shard ``s`` holds its
    per-shard spec's FLOWKV pool — same blocks and layers, only its
    contiguous kv-head slice). A plan lowers to exactly ONE K1 launch
    (``kv_transfer_fine``) per overlapping (src_shard, dst_shard) pair: the
    pair's coarse descriptor
    pages expand to fine ``(-1, head_dim)`` rows restricted to the pair's
    head intersection. head_dim is degree-invariant, so the fine rows match
    on both sides for ANY (tp_src, tp_dst); per-pair bytes sum exactly to the
    unsharded plan's bytes. The dst pools are updated in place.
    """

    def __init__(self, src_spec: L.KVCacheSpec, dst_spec: L.KVCacheSpec,
                 src_shard: ShardSpec, dst_shard: ShardSpec):
        if src_spec.head_dim != dst_spec.head_dim:
            raise ValueError("src/dst pools must agree on head_dim")
        if src_spec.block_size != dst_spec.block_size:
            raise ValueError("src/dst pools must agree on block_size")
        if src_spec.num_layers != dst_spec.num_layers:
            raise ValueError("src/dst pools must agree on layer count")
        if src_spec.num_kv_heads != dst_spec.num_kv_heads:
            raise ValueError("src/dst pools must cover the same kv-heads")
        self.src_spec = src_spec
        self.dst_spec = dst_spec
        self.src_shard = src_shard
        self.dst_shard = dst_shard
        self.planner = TransferPlanner(src_spec)
        self.num_dispatches = 0

    def plan(self, schedule: Schedule, src_blocks: Sequence[int],
             dst_blocks: Sequence[int]) -> TransferPlan:
        """A full-pool plan stamped with both sides' shard topology."""
        plan = self.planner.plan(schedule, src_blocks, dst_blocks)
        return dataclasses.replace(plan, src_shard=self.src_shard,
                                   dst_shard=self.dst_shard)

    def pair_rows(self, table: DescriptorTable, pair: Tuple[int, int, int, int],
                  device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
        """One pair's fine rows on each side (the rows its launch moves), as
        int32 tensors on ``device``."""
        dev = torch.device(device)
        return _pair_rows(table, pair, self.src_spec, self.src_shard,
                          self.dst_spec, self.dst_shard, (dev, dev))

    def execute(self, plan: TransferPlan, src_pools: Sequence[torch.Tensor],
                dst_pools: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Apply a plan pairwise, one K1 launch per pair, in place on the dst
        pools; returns them."""
        global _TOTAL_DISPATCHES
        table = plan.to_descriptors()
        out = list(dst_pools)
        if len(table) == 0:
            return out
        hd = self.src_spec.head_dim
        for pair in shard_pairs(self.src_shard, self.dst_shard):
            s, d, _, _ = pair
            dev = out[d].device
            src_rows, dst_rows = _pair_rows(table, pair, self.src_spec, self.src_shard,
                                            self.dst_spec, self.dst_shard, (dev, dev))
            self.num_dispatches += 1
            _TOTAL_DISPATCHES += 1
            kv_transfer_fine(src_pools[s], out[d], src_rows, dst_rows, hd)
        return out


def _pair_rows(table: DescriptorTable, pair: Tuple[int, int, int, int],
               src_spec: L.KVCacheSpec, src_shard: ShardSpec,
               dst_spec: L.KVCacheSpec, dst_shard: ShardSpec, devices
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pair's fine rows on each side, int32 tensors built on
    ``devices`` (src's, dst's)."""
    s, d, lo, hi = pair

    def rows(spec, shard, idx, side, dev):
        sspec = shard_slice_spec(spec, shard)
        first = shard.head_range(idx)[0]
        return _fine_rows_on(dev, table.page_ids(sspec, side), spec.block_size,
                             sspec.num_kv_heads, lo - first, hi - first)

    return (rows(src_spec, src_shard, s, "src", devices[0]),
            rows(dst_spec, dst_shard, d, "dst", devices[1]))


# ---------------------------------------------------------------------------
# Payload integrity: per-plan checksums over the pages a plan moves
# ---------------------------------------------------------------------------
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def page_bytes(pool: torch.Tensor, spec: L.KVCacheSpec,
               page_ids: np.ndarray) -> bytes:
    """Raw bytes of the given flat pages of a pool.

    The pages are gathered ON THE DEVICE, and only they are copied to the
    host, through an integer view of the same width (bfloat16 has no numpy
    dtype) — the same bytes the reference reads from its numpy copy.
    """
    flat = pool.reshape(-1, spec.payload)
    idx = torch.as_tensor(page_ids, dtype=torch.long).to(pool.device)
    sel = flat.index_select(0, idx).view(_INT_VIEW[pool.element_size()])
    return sel.cpu().numpy().tobytes()


def payload_digest(pool: torch.Tensor, spec: L.KVCacheSpec,
                   page_ids: np.ndarray) -> bytes:
    """blake2b digest of the given flat pages of a pool.

    The pool is viewed as ``(num_pages, spec.payload)`` — the same flat-page
    view the fused executor gathers/scatters through — so a digest over a
    plan's page ids covers exactly the bytes that plan moves, regardless of
    layout. Byte-for-byte equal to the reference's digest of the same pages.
    """
    import hashlib
    return hashlib.blake2b(page_bytes(pool, spec, page_ids),
                           digest_size=16).digest()


def _page_ints(pool: torch.Tensor, spec: L.KVCacheSpec,
               page_ids: np.ndarray) -> torch.Tensor:
    """The given flat pages of a pool, gathered on the pool's own device and
    viewed as same-width integers (the bytes ``page_bytes`` reads)."""
    flat = pool.reshape(-1, spec.payload).view(_INT_VIEW[pool.element_size()])
    return flat.index_select(0, torch.as_tensor(page_ids, dtype=torch.long).to(pool.device))


def verify_transfer(plan: TransferPlan, src_spec: L.KVCacheSpec,
                    src_pool: torch.Tensor, dst_spec: L.KVCacheSpec,
                    dst_pool: torch.Tensor) -> bool:
    """Post-dispatch integrity check: did the dst pages land bit-identical?

    Gathers the plan's source pages and destination pages (each through its
    own layout's page ordering, which pairs row-for-row by construction) on
    the pools' device and compares them as integers, so no page is copied
    to the host. The verdict is the reference's — its blake2b digests of
    the same bytes are equal exactly when the bytes are — including NaN
    payloads (equal bits verify) and -0.0 against +0.0 (they do not). An
    empty plan trivially verifies.
    """
    table = plan.to_descriptors()
    if len(table) == 0:
        return True
    if src_pool.element_size() != dst_pool.element_size():
        return False                     # unequal bytes (torch.equal compares values)
    return torch.equal(_page_ints(src_pool, src_spec, table.page_ids(src_spec, "src")),
                       _page_ints(dst_pool, dst_spec, table.page_ids(dst_spec, "dst")))


def verify_sharded_transfer(plan: TransferPlan, src_spec: L.KVCacheSpec,
                            src_pools: Sequence[torch.Tensor],
                            dst_spec: L.KVCacheSpec,
                            dst_pools: Sequence[torch.Tensor]) -> bool:
    """Shard-aware twin of :func:`verify_transfer`.

    For each overlapping (src_shard, dst_shard) pair, gathers the pair's
    fine ``(-1, head_dim)`` rows — exactly the rows its launch moved — on
    the pools' device and compares them as same-width integers: the
    reference's per-pair blake2b verdict, with no page copied to the host.
    The plan must carry shard topology; pools are per-shard lists.
    """
    table = plan.to_descriptors()
    if len(table) == 0:
        return True
    if not plan.sharded:
        raise ValueError("plan carries no shard topology; use verify_transfer")
    heads = (plan.src_shard or plan.dst_shard).num_kv_heads
    src_shard = plan.src_shard or ShardSpec(1, heads)
    dst_shard = plan.dst_shard or ShardSpec(1, heads)
    hd = src_spec.head_dim

    def ints(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        flat = pool.reshape(-1, hd).view(_INT_VIEW[pool.element_size()])
        return flat.index_select(0, rows.long())

    for pair in shard_pairs(src_shard, dst_shard):
        s, d, _, _ = pair
        if src_pools[s].element_size() != dst_pools[d].element_size():
            return False
        src_rows, dst_rows = _pair_rows(table, pair, src_spec, src_shard, dst_spec,
                                        dst_shard, (src_pools[s].device, dst_pools[d].device))
        if not torch.equal(ints(src_pools[s], src_rows), ints(dst_pools[d], dst_rows)):
            return False
    return True


def _pools_of(kv) -> List[torch.Tensor]:
    """Per-shard pool list of a paged cache port (tp=1 -> one-entry list)."""
    pools = getattr(kv, "pools", None)
    return list(pools) if pools is not None else [kv.pool]


def pool_transfer_engine(src_kv, dst_kv):
    """The transfer engine matching two pool ports' shard topology.

    Both unsharded stay on :class:`TransferEngine` (whole-payload pages, one
    launch per plan); any sharded side lowers through
    :class:`ShardedTransferEngine` (one launch per overlapping shard pair).
    Ports expose ``spec`` and, when sharded, ``tp`` / ``pools``
    (``serving/kv_cache.ShardedKVCache``).
    """
    s_tp = getattr(src_kv, "tp", 1)
    d_tp = getattr(dst_kv, "tp", 1)
    if s_tp == 1 and d_tp == 1:
        return TransferEngine(src_kv.spec, dst_kv.spec)
    return ShardedTransferEngine(
        src_kv.spec, dst_kv.spec,
        ShardSpec(s_tp, src_kv.spec.num_kv_heads),
        ShardSpec(d_tp, dst_kv.spec.num_kv_heads))


def land_plan(engine, plan: TransferPlan, src_kv, dst_kv) -> None:
    """Execute ``plan`` from ``src_kv`` into ``dst_kv`` (in place) on the
    engine :func:`pool_transfer_engine` chose for the two ports. A sharded
    engine takes either side unsharded as a one-shard pool holding every
    kv-head."""
    if not isinstance(engine, ShardedTransferEngine):
        dst_kv.import_plan(engine, plan, src_kv.pool)
    elif hasattr(dst_kv, "shards"):
        dst_kv.import_plan(engine, plan, _pools_of(src_kv))
    else:
        before = engine.num_dispatches
        engine.execute(plan, _pools_of(src_kv), [dst_kv.pool])
        dst_kv.num_pool_dispatches += engine.num_dispatches - before


def verify_pool_transfer(plan: TransferPlan, src_kv, dst_kv) -> bool:
    """Integrity check dispatching on the plan's shard topology."""
    if plan is not None and plan.sharded:
        return verify_sharded_transfer(plan, src_kv.spec, _pools_of(src_kv),
                                       dst_kv.spec, _pools_of(dst_kv))
    return verify_transfer(plan, src_kv.spec, src_kv.pool,
                           dst_kv.spec, dst_kv.pool)


def transfer_request(src_spec: L.KVCacheSpec, src_cache: torch.Tensor, src_blocks: Sequence[int],
                     dst_spec: L.KVCacheSpec, dst_cache: torch.Tensor, dst_blocks: Sequence[int],
                     schedule: Schedule = "flowkv",
                     profile: Optional[TransportProfile] = None):
    """One-shot convenience: plan + execute (in place) + (optionally) price.

    Returns (dst_cache, plan, latency_seconds_or_None).
    """
    engine = TransferEngine(src_spec, dst_spec)
    plan = engine.planner.plan(schedule, src_blocks, dst_blocks)
    dst_cache = engine.execute(plan, src_cache, dst_cache)
    latency = plan.latency(profile) if profile is not None else None
    return dst_cache, plan, latency


# ---------------------------------------------------------------------------
# TransferBackend protocol (see module docstring)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TransferJob:
    """One request's planned transfer: exact costs + backend bookkeeping."""

    request_id: int
    backend: str                        # registry key that produced the job
    schedule: str                       # "flowkv" | "blockwise" | "layerwise" | "state"
    num_calls: int
    num_bytes: int
    num_blocks: int = 0
    num_dispatches: int = 0             # fused kernel dispatches (paged: 0/1)
    plan: Optional[TransferPlan] = None          # paged backends
    src_blocks: Tuple[int, ...] = ()
    dst_blocks: Tuple[int, ...] = ()
    state_bytes: int = 0                # a state slot's row moved beside the pages
    state_slots: Tuple[int, ...] = ()   # (src slot, dst slot)


class TransferBackend:
    """Protocol base: plan / execute / price one request's state movement."""

    name: str = "abstract"

    def plan(self, req, src, dst) -> TransferJob:
        raise NotImplementedError

    def execute(self, job: TransferJob, src, dst) -> None:
        raise NotImplementedError

    def price(self, job: TransferJob, profile: TransportProfile) -> float:
        if job.plan is not None:
            return job.plan.latency(profile)
        return profile.latency(num_calls=job.num_calls, num_bytes=job.num_bytes)


def _plan_block_job(backend: str, schedule: Schedule, planner: TransferPlanner,
                    spec: L.KVCacheSpec, req, src_bm, register_dst,
                    dst_bm) -> TransferJob:
    """Shared paged planning: get src blocks, register dst blocks (rolled
    back if planning fails), and build the priced job."""
    n = spec.blocks_for_tokens(req.prompt_len)
    src_blocks = src_bm.get(req.request_id)[:n]
    dst_blocks = register_dst(req)[:n]
    try:
        plan = planner.plan(schedule, src_blocks, dst_blocks)
    except BaseException:
        dst_bm.free(req.request_id)      # don't strand the registration
        raise
    return TransferJob(
        request_id=req.request_id, backend=backend, schedule=schedule,
        num_calls=plan.num_calls, num_bytes=plan.total_bytes,
        num_blocks=plan.num_blocks, num_dispatches=plan.num_dispatches,
        plan=plan,
        src_blocks=tuple(int(b) for b in src_blocks),
        dst_blocks=tuple(int(b) for b in dst_blocks))


class PagedBackend(TransferBackend):
    """Block-granular KV movement between two paged pools.

    ``src`` / ``dst`` ports must expose ``kv`` (a pool with ``spec`` /
    ``pool`` / ``bm`` / ``import_plan``) and
    ``dst.register_transfer_in(req, num_tokens)``.
    """

    name = "paged"

    def __init__(self, schedule: Schedule = "flowkv"):
        self.schedule: Schedule = schedule

    def plan(self, req, src, dst) -> TransferJob:
        spec = src.kv.spec
        job = _plan_block_job(
            self.name, self.schedule, TransferPlanner(spec), spec, req,
            src.kv.bm, lambda r: dst.register_transfer_in(r, r.prompt_len + 1),
            dst.kv.bm)
        s_tp = getattr(src.kv, "tp", 1)
        d_tp = getattr(dst.kv, "tp", 1)
        if s_tp > 1 or d_tp > 1:
            # stamp shard topology at PLAN time so verification and windowed
            # splits downstream see the pair structure; num_dispatches
            # becomes the pair count (one K1 launch per overlap)
            job.plan = dataclasses.replace(
                job.plan,
                src_shard=ShardSpec(s_tp, src.kv.spec.num_kv_heads),
                dst_shard=ShardSpec(d_tp, dst.kv.spec.num_kv_heads))
            job.num_dispatches = job.plan.num_dispatches
        return job

    def execute(self, job: TransferJob, src, dst) -> None:
        engine = pool_transfer_engine(src.kv, dst.kv)
        land_plan(engine, job.plan, src.kv, dst.kv)
        job.num_dispatches = engine.num_dispatches


class StateBackend(TransferBackend):
    """Whole-pytree movement for the state families (ssm / hybrid / encdec).

    The cache ships as one logical segment per leaf; the destination still
    reserves block-manager budget so admission control / KV_u accounting
    stays uniform with the paged path.
    """

    name = "state"

    def plan(self, req, src, dst) -> TransferJob:
        leaves = list(src.states[req.request_id].values())
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        dst.register_transfer_in(req, req.prompt_len + 1)
        return TransferJob(request_id=req.request_id, backend=self.name,
                           schedule="state", num_calls=len(leaves),
                           num_bytes=nbytes, num_dispatches=1)

    def execute(self, job: TransferJob, src, dst) -> None:
        # the handoff moves the tensors by reference: both nodes' engines
        # share one process (and, on the GPU, one card)
        dst.import_state_by_id(job.request_id, src.export_state_by_id(job.request_id))


class PagedStateBackend(PagedBackend):
    """The pages of a family's attention layers plus its request's state
    slot (``serving/state_slots.StateSlots``): the page plan as
    :class:`PagedBackend` makes it, then ONE contiguous copy of the slot's
    row from the source node's slots into a slot taken on the destination,
    on the device (a real copy, not a hand-off). The job counts the page
    plan's calls and dispatches plus one, its bytes include the row, and
    its price covers both. Ports also expose ``slots``."""

    name = "paged_state"

    def plan(self, req, src, dst) -> TransferJob:
        dst_slot = dst.slots.acquire(req.request_id)
        if dst_slot is None:
            raise RuntimeError(f"no free state slot on node {dst.node_id} for request "
                               f"{req.request_id}")
        try:
            job = super().plan(req, src, dst)
        except BaseException:
            dst.slots.release(req.request_id)
            raise
        job.backend = self.name
        job.state_bytes = src.slots.slot_bytes
        job.state_slots = (src.slots.slot_of(req.request_id), dst_slot)
        job.num_calls += 1
        job.num_dispatches += 1
        job.num_bytes += job.state_bytes
        return job

    def execute(self, job: TransferJob, src, dst) -> None:
        super().execute(job, src, dst)
        dst.slots.copy_from(src.slots, *job.state_slots)
        job.num_dispatches += 1

    def price(self, job: TransferJob, profile: TransportProfile) -> float:
        return profile.latency(num_calls=job.num_calls, num_bytes=job.num_bytes)


class SimulatedBackend(TransferBackend):
    """Exact planning + pricing with a no-op data plane (e.g. a modeled DCN
    hop). Ports are ``SimNode``-shaped: ``bm`` / ``kv_spec`` / ``planner``.
    Call and dispatch counts come from the same descriptor tables the real
    executor runs, so simulated tables match hardware tables exactly.
    """

    name = "sim"

    def __init__(self, schedule: Schedule = "flowkv"):
        self.schedule: Schedule = schedule

    def plan(self, req, src, dst) -> TransferJob:
        job = _plan_block_job(
            self.name, self.schedule, src.planner, src.kv_spec, req,
            src.bm, lambda r: dst.bm.register(r.request_id, r.prompt_len + 1),
            dst.bm)
        s_tp = getattr(src, "tp", 1)
        d_tp = getattr(dst, "tp", 1)
        if s_tp > 1 or d_tp > 1:
            # same plan-time stamping as PagedBackend: the priced dispatch
            # count becomes the shard-pair count, so simulated tables match
            # what the sharded executor would dispatch on hardware
            job.plan = dataclasses.replace(
                job.plan,
                src_shard=ShardSpec(s_tp, src.kv_spec.num_kv_heads),
                dst_shard=ShardSpec(d_tp, dst.kv_spec.num_kv_heads))
            job.num_dispatches = job.plan.num_dispatches
        return job

    def execute(self, job: TransferJob, src, dst) -> None:
        pass   # data plane is virtual in the simulator


# -- registry ----------------------------------------------------------------
_BACKENDS: Dict[str, Callable[..., TransferBackend]] = {}


def register_backend(name: str, factory: Callable[..., TransferBackend]) -> None:
    _BACKENDS[name] = factory


def get_backend(name: str, **kwargs) -> TransferBackend:
    try:
        factory = _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown transfer backend {name!r}; "
            f"registered: {sorted(_BACKENDS)}") from None
    return factory(**kwargs)


def available_backends() -> List[str]:
    return sorted(_BACKENDS)


def backend_for_engine(engine, schedule: Schedule = "flowkv") -> TransferBackend:
    """Pick the backend matching an engine port's cache transport."""
    if getattr(engine, "slots", None) is not None:
        return get_backend("paged_state", schedule=schedule)
    if getattr(engine, "paged", False):
        return get_backend("paged", schedule=schedule)
    return get_backend("state")


register_backend("paged", PagedBackend)
register_backend("state", StateBackend)
register_backend("paged_state", PagedStateBackend)
register_backend("sim", SimulatedBackend)