"""FlowKV core: the paper's contribution.

C1 — low-latency KV-cache transfer: ``layout`` (Eq. 5 transform),
``allocator``/``block_manager`` (segment allocation), ``alignment``
(bidirectional segment alignment), ``transfer`` (planner + engine),
``costmodel`` (Table-3-calibrated transports).

C2 — load-aware scheduling: ``scheduler`` (metrics, scores, hybrid
scheduler, global controller).
"""
from repro_torch.core.alignment import AlignedRun, AlignmentResult, align
from repro_torch.core.allocator import (BlockAllocator, OutOfBlocksError,
                                  SegmentAllocator, make_allocator)
from repro_torch.core.block_manager import BlockManager
from repro_torch.core.layout import KVCacheSpec, KVLayout
from repro_torch.core.segments import Segment, blocks_to_segments, segments_to_blocks
from repro_torch.core.transfer import (TransferEngine, TransferPlan, TransferPlanner,
                                 transfer_request)

__all__ = [
    "AlignedRun", "AlignmentResult", "align", "BlockAllocator",
    "OutOfBlocksError", "SegmentAllocator", "make_allocator", "BlockManager",
    "KVCacheSpec", "KVLayout", "Segment", "blocks_to_segments",
    "segments_to_blocks", "TransferEngine", "TransferPlan", "TransferPlanner",
    "transfer_request",
]
