"""Transfer cost models, calibrated against the paper's Table 3.

The quantity FlowKV optimizes is::

    latency = num_calls * per_call_overhead + bytes / bandwidth + fixed

``num_calls`` comes from the transfer planner (exact, not modeled); the
constants below are calibrated so the Table-3 grid reproduces within a few
percent (see ``benchmarks/transfer_latency.py`` and
``tests/test_costmodel.py``).

Calibration notes (Llama-3.1-8B: L=32, kv=8, hd=128, bf16, block=32 tokens,
so 128 KiB/token and ~23.5k layerwise calls at 11.7k ctx — matching the
paper's 23,469):

* ``nccl``        — per-call ~73 µs: FlowKV-Layerwise single-machine 12k ctx
                    = 1.72 s at 23.5k calls.
* ``ipc``         — ~23 GB/s: FlowKV single-machine 12k ctx = 0.068 s for
                    1.57 GB.
* ``nccl_eni``    — ~9 GB/s cross-machine: FlowKV multi-machine 12k = 0.176 s.
* ``vllm_merge``  — vLLM-Disagg's layer-buffer merge path: effective
                    ~0.75 GB/s (merge memcpy + per-layer calls), matching
                    2.19 s at 12k.
* ``mooncake``    — RDMA path without NIC-direct VRAM exchange: ~0.5 GB/s
                    effective plus high setup, matching 2.03 s at 8k.

TPU-side profiles (the *target* hardware) use the system constants:
ICI ~50 GB/s/link, DCN modeled at 25 GB/s/host, per-DMA-descriptor
dispatch ~8 µs. These drive the TPU columns of the benchmark and the
serving simulator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TransportProfile:
    """latency(calls, bytes) = calls*per_call + bytes/bandwidth + fixed."""

    name: str
    per_call_s: float          # per contiguous-range call (kernel/descriptor)
    bandwidth_Bps: float       # steady-state bandwidth for merged payloads
    fixed_s: float = 0.0       # handshake / metadata exchange
    per_byte_extra_s: float = 0.0  # extra per-byte work (e.g. merge memcpy)

    def latency(self, num_calls: int, num_bytes: int) -> float:
        return (
            self.fixed_s
            + num_calls * self.per_call_s
            + num_bytes / self.bandwidth_Bps
            + num_bytes * self.per_byte_extra_s
        )


# --- GPU-world profiles (paper's measurement environment) --------------------
NCCL_INTRA = TransportProfile(  # NCCL over NVLink, same machine
    name="nccl",
    per_call_s=73e-6,
    bandwidth_Bps=23e9,
    fixed_s=4e-4,
)
NCCL_ENI = TransportProfile(  # NCCL over Elastic Network Interface, cross machine
    name="nccl_eni",
    per_call_s=105e-6,
    bandwidth_Bps=9.2e9,
    fixed_s=1.5e-3,
)
IPC = TransportProfile(  # cudaIpc same-machine peer copy
    name="ipc",
    per_call_s=12e-6,
    bandwidth_Bps=23.5e9,
    fixed_s=2e-4,
)
VLLM_MERGE_INTRA = TransportProfile(  # vLLM-disagg: merge layer buffers, then send
    name="vllm_merge",
    per_call_s=73e-6,           # one NCCL call per layer buffer (2L calls)
    bandwidth_Bps=23e9,
    fixed_s=5e-4,
    per_byte_extra_s=1.0 / 0.80e9,  # small-chunk merge memcpy, effective ~0.8 GB/s
)
VLLM_MERGE_ENI = TransportProfile(
    name="vllm_merge_eni",
    per_call_s=105e-6,
    bandwidth_Bps=9.2e9,
    fixed_s=1.5e-3,
    per_byte_extra_s=1.0 / 0.85e9,
)
MOONCAKE_RDMA = TransportProfile(  # RDMA without NIC-direct VRAM exchange
    name="mooncake_rdma",
    per_call_s=30e-6,
    bandwidth_Bps=0.53e9,
    fixed_s=2.5e-2,
)

# --- TPU-world profiles (the port target) ------------------------------------
TPU_ICI = TransportProfile(  # same-pod, over ICI links
    name="tpu_ici",
    per_call_s=8e-6,           # DMA descriptor dispatch
    bandwidth_Bps=50e9,        # per-link ICI (system constant)
    fixed_s=5e-5,
)
TPU_DCN = TransportProfile(  # cross-pod, over data-center network
    name="tpu_dcn",
    per_call_s=20e-6,
    bandwidth_Bps=25e9,
    fixed_s=5e-4,
)

# --- tiered KV store (Mooncake direction) -------------------------------------
HOST_DRAM = TransportProfile(
    # Host-DRAM tier leg: pageable-host staging + pinning + page re-layout
    # on the way back into the pool. Deliberately SLOWER than every wire
    # profile ``select_route`` can return (IPC 23.5, NCCL_ENI 9.2, ICI 50,
    # DCN 25 GB/s) so the router's tier lattice holds by construction:
    # HBM-local < HBM-remote < DRAM-local < DRAM-remote < recompute.
    name="host_dram",
    per_call_s=150e-6,         # pin + descriptor-table staging per dispatch
    bandwidth_Bps=6.0e9,       # pageable H2D/D2H effective bandwidth
    fixed_s=3e-4,
)

PROFILES: Dict[str, TransportProfile] = {
    p.name: p
    for p in (
        NCCL_INTRA,
        NCCL_ENI,
        IPC,
        VLLM_MERGE_INTRA,
        VLLM_MERGE_ENI,
        MOONCAKE_RDMA,
        TPU_ICI,
        TPU_DCN,
        HOST_DRAM,
    )
}


def get_profile(name: str) -> TransportProfile:
    try:
        return PROFILES[name]
    except KeyError as e:
        raise ValueError(f"unknown transport profile {name!r}; have {sorted(PROFILES)}") from e


def predicted_ttft_s(queued_flops: float, new_flops: float,
                     effective_flops: float,
                     overhead_s: float = 0.0) -> float:
    """Admission-time TTFT prediction (Mooncake-style, arXiv:2407.00079 §5).

    Prefill is compute-bound, so time-to-first-token on a node is the queued
    prefill work plus this request's own compute over the node's *effective*
    throughput (peak FLOPs x achievable MFU). The global controller uses
    this both to pick the min-TTFT prefill node (Alg. 1 routing) and to gate
    admission: a predicted TTFT beyond the SLO means the request is doomed
    before it runs, and rejecting it NOW is cheaper than serving it late.
    ``HardwareProfile.prefill_time`` delegates here (queued_flops=0), so the
    simulator's step-time model and the controller's estimates are one
    formula.
    """
    return overhead_s + (queued_flops + new_flops) / max(effective_flops, 1.0)


def predicted_chunked_ttft_s(backlog_tokens: Sequence[float],
                             new_tokens: float, chunk_tokens: float,
                             flops_per_token: float, effective_flops: float,
                             overhead_s: float = 0.0) -> float:
    """Admission-time TTFT under CHUNKED prefill interleaving.

    The whole-prompt estimator (:func:`predicted_ttft_s`) charges a new
    request the node's ENTIRE queued prefill backlog — under chunking that
    is a head-of-line fiction: a long prompt only claims ``chunk_tokens``
    per cycle, so a short prompt queued behind it interleaves instead of
    waiting the long prompt out. While this request runs its own
    ``ceil(new_tokens / chunk_tokens)`` chunks, each queued request can
    delay it by AT MOST ``own_cycles * chunk_tokens`` of concurrent chunk
    work — any backlog beyond that executes after this request's first
    token and must not be priced into its TTFT.

    ``backlog_tokens`` is per-request REMAINING prefill tokens queued ahead
    (``HybridScheduler.prefill_backlog_tokens``). With ``chunk_tokens``
    >= every prompt the bound is inactive and this reduces exactly to
    :func:`predicted_ttft_s` over the same backlog.
    """
    chunk = max(1.0, float(chunk_tokens))
    own_cycles = max(1.0, -(-float(new_tokens) // chunk))   # ceil, >= 1
    delayed = sum(min(float(b), own_cycles * chunk) for b in backlog_tokens)
    return predicted_ttft_s(delayed * flops_per_token,
                            new_tokens * flops_per_token,
                            effective_flops, overhead_s)


def layer_window_overlap(window_latencies: Sequence[float],
                         window_layer_ends: Sequence[int],
                         num_layers: int,
                         prefill_s: float) -> Tuple[float, float]:
    """Price a layerwise-pipelined transfer: returns ``(exposed_s, hidden_s)``.

    Window w (layers ``[.., window_layer_ends[w])``) becomes sendable when
    the producing prefill pass finishes its last layer — modeled as the
    uniform-layer point ``prefill_s * end_w / num_layers`` — and windows
    serialize on one transport link::

        finish_w = max(finish_{w-1}, ready_w) + latency_w

    The request only WAITS for what spills past the end of prefill:
    ``exposed = max(0, finish_last - prefill_s)``; the rest of the wire
    time is hidden behind compute. This one function is the single pricing
    source for the real cluster (``PDCluster._transfer``), the simulator
    (``ClusterSim._start_transfer``) and the controller's routing estimate,
    so load-aware scheduling sees exactly the gain the data plane realizes.
    With one window ready at the end (``prefill_s * L/L``) nothing hides:
    ``exposed == total`` — the unoverlapped baseline.
    """
    finish = 0.0
    total = 0.0
    for end, lat in zip(window_layer_ends, window_latencies):
        ready = prefill_s * end / max(1, num_layers)
        finish = max(finish, ready) + lat
        total += lat
    exposed = max(0.0, finish - prefill_s)
    return exposed, total - exposed


def estimate_overlapped_transfer_s(profile: TransportProfile, num_bytes: int,
                                   num_layers: int, layer_window: int,
                                   prefill_s: float,
                                   calls_per_window: int = 1) -> float:
    """Routing-time estimate of the EXPOSED transfer latency under
    layer-window overlap, without a concrete plan: bytes split evenly over
    ``ceil(num_layers / layer_window)`` windows, each priced as its own
    transport call(s), then run through :func:`layer_window_overlap`.
    ``layer_window <= 0`` (overlap off) prices the classic single call.
    """
    if layer_window <= 0 or layer_window >= num_layers:
        return profile.latency(num_calls=calls_per_window,
                               num_bytes=int(num_bytes))
    ends = list(range(layer_window, num_layers, layer_window)) + [num_layers]
    lats = []
    prev = 0
    for end in ends:
        bytes_w = num_bytes * end // num_layers - num_bytes * prev // num_layers
        lats.append(profile.latency(num_calls=calls_per_window,
                                    num_bytes=int(bytes_w)))
        prev = end
    exposed, _ = layer_window_overlap(lats, ends, num_layers, prefill_s)
    return exposed


def sharded_transfer_calls(tp_src: int, tp_dst: int) -> int:
    """Fused dispatches a cross-degree pool transfer costs: one per
    overlapping (src_shard, dst_shard) pair of the two contiguous
    equal-width kv-head partitions.

    Merging the two partitions' cut points gives
    ``tp_src + tp_dst - gcd(tp_src, tp_dst)`` intervals (each interval is
    exactly one pair); same-degree transfers collapse to ``tp`` pairwise
    shard-local dispatches and the tp=1/tp=1 case to the classic single
    dispatch. This is the routing-time twin of
    ``core.transfer.TransferPlan.num_dispatches`` on a sharded plan.
    """
    return tp_src + tp_dst - math.gcd(tp_src, tp_dst)


def tier_fetch_latency(route: TransportProfile, hbm_bytes: int,
                       dram_bytes: int, remote: bool = True) -> float:
    """Price a tier-aware prefix fetch as its fused-dispatch legs.

    ``dram_bytes`` of the prefix sit in the source's host tier and must be
    PROMOTED first (one host->HBM descriptor-table dispatch on the
    :data:`HOST_DRAM` leg); then, when the source is ``remote``, the whole
    prefix (``hbm_bytes + dram_bytes``) crosses the wire as one more fused
    dispatch on ``route``. A local hit with no DRAM blocks is free (the
    blocks are shared, nothing moves), which is what keeps the lattice
    HBM-local < HBM-remote < DRAM-local < DRAM-remote.
    """
    latency = 0.0
    if dram_bytes > 0:
        latency += HOST_DRAM.latency(num_calls=1, num_bytes=int(dram_bytes))
    if remote:
        latency += route.latency(num_calls=1,
                                 num_bytes=int(hbm_bytes + dram_bytes))
    return latency


def select_route(same_host: bool, target: str = "gpu") -> TransportProfile:
    """FlowKV §3.2: 'selects the best transfer pipeline based on hardware'.

    GPU world: IPC inside a machine, NCCL across. TPU world: ICI inside a
    pod, DCN across pods.
    """
    if target == "gpu":
        return IPC if same_host else NCCL_ENI
    if target == "tpu":
        return TPU_ICI if same_host else TPU_DCN
    raise ValueError(f"unknown target {target!r}")
