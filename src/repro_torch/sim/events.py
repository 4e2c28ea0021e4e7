"""Minimal discrete-event core: a heap of (time, seq, callback)."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Tuple


class EventQueue:
    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.now = 0.0

    def push(self, when: float, fn: Callable[[], None]) -> None:
        if when < self.now:
            when = self.now
        heapq.heappush(self._heap, (when, next(self._seq), fn))

    def __bool__(self) -> bool:
        return bool(self._heap)

    def run_until(self, t_end: float = float("inf"), max_events: int = 10_000_000) -> None:
        n = 0
        while self._heap and n < max_events:
            when, _, fn = heapq.heappop(self._heap)
            if when > t_end:
                heapq.heappush(self._heap, (when, next(self._seq), fn))
                break
            self.now = when
            fn()
            n += 1
