"""A node's state slots: the Mamba-2 state of the granitemoehybrid family,
held beside the paged pool of its attention layers.

One device buffer of ``num_slots + 1`` slot-major rows: a request's whole
state (every Mamba-2 layer's fp32 ``h``, then every layer's conv tail in the
served type) is one contiguous row of ``cfg.state_slot_bytes()`` bytes, so
that the P->D transfer moves it with one copy. ``h`` (S, Lm, H, P, N) and
``conv`` (S, Lm, cw-1, di+2N) are typed views of the rows, which the decode
step reads and writes in place by slot id. The last row is the scratch
slot that a decode step's pad lanes read and write; no request holds it.

A request holds a slot from its first prefill chunk (or its arrival by
transfer) until it finishes, leaves the node, or is spilled, when its row
goes to the host with its pages (:meth:`save` / :meth:`load`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.granite_hybrid import conv_width


class StateSlots:
    """``num_slots`` state slots plus the scratch slot on one device."""

    def __init__(self, cfg: ModelConfig, num_slots: int, device=None):
        if num_slots < 1:
            raise ValueError(f"{cfg.name}: a node needs at least one state slot "
                             f"(ModelConfig.state_slots), got {num_slots}")
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.slot_bytes = cfg.state_slot_bytes()
        kinds = cfg.layer_kinds()
        lm = kinds.count("mamba")
        h_shape = (lm, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        c_shape = (lm, cfg.ssm_conv - 1, conv_width(cfg))
        h_bytes = 4 * math.prod(h_shape)
        align = max(4, cfg.dtype.itemsize)
        if self.slot_bytes % align or h_bytes % align:
            raise ValueError(f"slot of {self.slot_bytes} B cannot hold aligned views")
        rows = num_slots + 1
        self.buf = torch.zeros((rows, self.slot_bytes), dtype=torch.uint8, device=self.device)
        self.h = self.buf[:, :h_bytes].view(torch.float32).view(rows, *h_shape)
        self.conv = self.buf[:, h_bytes:].view(cfg.dtype).view(rows, *c_shape)
        self.scratch = num_slots
        self._free: List[int] = list(range(num_slots))
        self._owner: Dict[int, int] = {}          # request id -> slot
        self.peak_held = 0                        # most slots held at once
        self.spills = 0                           # slots saved to the host

    # -- ownership --------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_held(self) -> int:
        return len(self._owner)

    def owns(self, request_id: int) -> bool:
        return request_id in self._owner

    def slot_of(self, request_id: int) -> int:
        return self._owner[request_id]

    def acquire(self, request_id: int) -> Optional[int]:
        """The request's slot, taken now if it holds none; None where every
        slot is held."""
        slot = self._owner.get(request_id)
        if slot is None:
            if not self._free:
                return None
            slot = self._owner[request_id] = self._free.pop(0)
            self.peak_held = max(self.peak_held, len(self._owner))
        return slot

    def release(self, request_id: int) -> bool:
        slot = self._owner.pop(request_id, None)
        if slot is None:
            return False
        self._free.append(slot)
        return True

    def release_all(self) -> None:
        for rid in list(self._owner):
            self.release(rid)

    # -- data ---------------------------------------------------------------------
    def store(self, request_id: int, conv: torch.Tensor, h: torch.Tensor) -> None:
        """Write one request's state: conv (Lm, cw-1, C), h (Lm, H, P, N)."""
        slot = self._owner[request_id]
        self.conv[slot].copy_(conv)
        self.h[slot].copy_(h)

    def save(self, request_id: int) -> torch.Tensor:
        """The request's row copied to the host, and its slot released."""
        row = self.buf[self._owner[request_id]].cpu()
        self.release(request_id)
        self.spills += 1
        return row

    def load(self, request_id: int, row: torch.Tensor) -> None:
        """Write a saved row back into the request's (acquired) slot."""
        self.buf[self._owner[request_id]].copy_(row)

    def copy_from(self, src: "StateSlots", src_slot: int, dst_slot: int) -> None:
        """One contiguous device copy of a slot's row from ``src``'s buffer."""
        self.buf[dst_slot].copy_(src.buf[src_slot])
