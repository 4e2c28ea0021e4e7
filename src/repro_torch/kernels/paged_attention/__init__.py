from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.ref import (paged_decode_attention_ref,
                                                     paged_decode_attention_stats_ref)

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "paged_decode_attention_stats_ref"]
