"""What the models and the kernel wrappers tell an op counter, below both.

An op counter (``launch/op_counts.OpCounter``) is a ``TorchDispatchMode``
that counts the aten ops of a step, usually run on ``meta`` tensors. Two
things it cannot see for itself come from the code it counts:

* :func:`report`: a hand-written kernel (K1, K3, K4) has no aten op. On
  ``meta`` tensors its wrapper allocates the output and reports the
  kernel's own work here, which adds it to every active counter.
* :func:`trips`: a loop whose iterations all have one shape may run once on
  ``meta`` and be counted ``n`` times, the reference's multiplication of a
  ``while`` body by its trip count (the chunked flash attention of a long
  prefill and mamba2's SSD chunk scan do this; a body that autograd
  records never does).

This module imports nothing of the port, so ``models`` and ``kernels``
depend on it and not on ``launch``.
"""
from __future__ import annotations

from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack


class CountingMode(TorchDispatchMode):
    """The part of an op counter that :func:`report` and :func:`trips`
    reach: ``scale``, the trips of the loop body now running, and
    ``add_kernel``, which a subclass counts a kernel's work into."""

    def __init__(self):
        super().__init__()
        self.scale = 1

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        raise NotImplementedError


def active() -> list:
    """The op counters on the dispatch-mode stack."""
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, CountingMode)]


def report(kernel: str, flops: int, nbytes: int) -> None:
    """A hand-written kernel's work on ``meta`` tensors, added to every
    active counter (its wrapper calls this where it would have launched)."""
    for mode in active():
        mode.add_kernel(kernel, int(flops), int(nbytes))


class trips:
    """``range(n)`` for a loop whose ``n`` iterations have the same shapes.

    On ``meta`` under an op counter, where autograd does not record the
    body (``like`` needs no gradient), iterating yields 0 alone and counts
    that one pass ``n`` times. ``reps`` is how many iterations each pass
    stands for (``n`` then, else 1): a caller that joins what the body
    collects repeats its list ``reps`` times, so the join reads all ``n``
    though the live set holds one.
    """

    def __init__(self, n: int, like: torch.Tensor):
        recorded = torch.is_grad_enabled() and like.requires_grad
        self.n = n
        self._counters = active() if n > 1 and like.is_meta and not recorded else []
        self.reps = n if self._counters else 1

    def __iter__(self) -> Iterator[int]:
        if not self._counters:
            yield from range(self.n)
            return
        for mode in self._counters:
            mode.scale *= self.n
        try:
            yield 0
        finally:
            for mode in self._counters:
                mode.scale //= self.n
