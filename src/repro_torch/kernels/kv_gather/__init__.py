from repro_torch.kernels.kv_gather.kv_append import (append_slot_ids,
                                                     kv_append_tokens, stage_tokens)
from repro_torch.kernels.kv_gather.ops import (kv_gather, kv_scatter, kv_transfer,
                                               kv_transfer_fine)
from repro_torch.kernels.kv_gather.ref import (kv_append_ref, kv_gather_ref,
                                               kv_scatter_ref, kv_transfer_ref)

__all__ = ["kv_transfer", "kv_transfer_fine", "kv_gather", "kv_scatter", "kv_append_tokens",
           "append_slot_ids", "stage_tokens", "kv_transfer_ref", "kv_gather_ref",
           "kv_scatter_ref", "kv_append_ref"]
