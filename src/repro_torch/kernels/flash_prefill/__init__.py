from repro_torch.kernels.flash_prefill.ops import flash_prefill_op
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref, flash_prefill_split_ref

__all__ = ["flash_prefill_op", "flash_prefill_ref", "flash_prefill_split_ref"]
