"""Hardware profiles for the cluster simulator and the controller's cost
estimates.

GPU profiles cover the paper's measurement fleet (A100 homogeneous, L20/H20
heterogeneous) and the PyTorch port's target, the H100 SXM (NVIDIA data
sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 80 GB); TPU v5e uses the
system constants (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).

Step-time estimation follows the standard roofline split: prefill is
compute-bound (FLOPs / peak), decode is memory-bound (weight + KV bytes /
HBM bandwidth), each with a floor from kernel-dispatch overhead.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.costmodel import (NCCL_ENI, IPC, TPU_DCN, TPU_ICI,
                                  TransportProfile, predicted_ttft_s)


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float           # bf16 FLOP/s per device
    hbm_bandwidth: float        # bytes/s per device
    hbm_bytes: int              # capacity per device
    intra_host: TransportProfile
    inter_host: TransportProfile
    mfu_prefill: float = 0.55   # achievable fraction of peak in prefill
    mbu_decode: float = 0.60    # achievable fraction of HBM bw in decode
    step_overhead_s: float = 4e-3

    # -- step-time estimates --------------------------------------------------
    def prefill_time(self, flops: float) -> float:
        # one formula with the controller's routing/admission TTFT estimate
        return predicted_ttft_s(0.0, flops,
                                self.peak_flops * self.mfu_prefill,
                                self.step_overhead_s)

    def decode_time(self, bytes_moved: float) -> float:
        return self.step_overhead_s + bytes_moved / (self.hbm_bandwidth * self.mbu_decode)


A100 = HardwareProfile(
    name="A100-80G",
    peak_flops=312e12, hbm_bandwidth=2.0e12, hbm_bytes=80 << 30,
    intra_host=IPC, inter_host=NCCL_ENI,
)
L20 = HardwareProfile(  # compute-lean, bandwidth-lean (48 GB) — paper's P-friendly card
    name="L20-48G",
    peak_flops=119e12, hbm_bandwidth=0.864e12, hbm_bytes=48 << 30,
    intra_host=IPC, inter_host=NCCL_ENI,
)
H20 = HardwareProfile(  # compute-lean but bandwidth/memory-rich — paper's D-friendly card
    name="H20-96G",
    peak_flops=148e12, hbm_bandwidth=4.0e12, hbm_bytes=96 << 30,
    intra_host=IPC, inter_host=NCCL_ENI,
)
H100 = HardwareProfile(  # data-sheet constants, SXM part, dense bf16
    name="H100-80G",
    peak_flops=989e12, hbm_bandwidth=3.35e12, hbm_bytes=80 * 10**9,
    intra_host=IPC, inter_host=NCCL_ENI,
)
TPU_V5E = HardwareProfile(
    name="TPUv5e",
    peak_flops=197e12, hbm_bandwidth=819e9, hbm_bytes=16 << 30,
    intra_host=TPU_ICI, inter_host=TPU_DCN,
)

PROFILES = {p.name: p for p in (A100, L20, H20, H100, TPU_V5E)}
ALIASES = {"a100": A100, "l20": L20, "h20": H20, "h100": H100,
           "tpuv5e": TPU_V5E, "v5e": TPU_V5E}


def get_hardware(name: str) -> HardwareProfile:
    key = name.lower()
    if key in ALIASES:
        return ALIASES[key]
    if name in PROFILES:
        return PROFILES[name]
    raise ValueError(f"unknown hardware {name!r}; have {sorted(ALIASES)}")
