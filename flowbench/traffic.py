"""The one traffic generator: reads a mix's parameters (``traffic/<name>.json``)
and a cell's load (``cells/<workload>.json``) and makes the requests of a run
from ``--seed``.

Every draw is stratified: ``n`` lengths (or gaps) are the distribution's
quantiles at ``(i + 0.5) / n``, shuffled by the seed. So every seed sends the
same multiset of sizes and arrival gaps in another order, and two seeds
differ in ordering and token ids, not in the amount of work. Token ids are
drawn uniformly from the configuration's vocabulary.

Two loops:

* ``open``: a Poisson process at the cell's ``rate`` (exponential gaps). The
  pre-roll's arrivals fill ``[-preroll_s, 0)`` and the window's ``[0,
  seconds)``; a request is due at its arrival and timed from then. With
  ``round: m`` in the mix, sizes and gaps are stratified in rounds of m
  consecutive arrivals, so the long prompts spread through the window. With
  ``schedule_seed: k`` the order of sizes and gaps is drawn from k, not from
  ``--seed``: every seed then offers the same schedule (an open loop near
  its knee queues differently for every order, and that difference would
  swamp what a change to the program moves), and the seed draws the token
  ids and the weights.
* ``closed``: the cell's ``clients`` each send their next request when the
  last one finished. The i-th request sent takes the i-th size of a list
  made of rounds of ``clients`` sizes, each round stratified on its own, so
  the fill (the first round) and every later round hold the same sizes for
  every seed. A client's first request draws its output length uniformly
  below its drawn length (``first_output: uniform_below``), so completions
  spread from the start. ``schedule_seed`` fixes the order of the sizes as
  in the open loop: which sizes a window meets depends on their order, so
  without it the tokens a second of a window move with the seed.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional

import numpy as np

_NORMAL = statistics.NormalDist()


def quantile(spec: Dict, u: float) -> float:
    """The inverse CDF of a length or gap distribution at ``u`` in (0, 1)."""
    dist = spec["dist"]
    if dist == "lognormal":
        x = spec["median"] * math.exp(spec["sigma"] * _NORMAL.inv_cdf(u))
    elif dist == "normal":
        x = spec["mean"] + spec["std"] * _NORMAL.inv_cdf(u)
    elif dist == "uniform":
        x = spec["min"] + u * (spec["max"] - spec["min"] + 1)
    elif dist == "exponential":
        x = -math.log1p(-u) * spec.get("mean", 1.0)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    lo, hi = spec.get("min", -math.inf), spec.get("max", math.inf)
    return min(max(x, lo), hi)


def stratified(spec: Dict, n: int, rng: np.random.Generator,
               integer: bool = True) -> np.ndarray:
    """``n`` draws: the quantiles at (i + 0.5) / n in an order set by ``rng``."""
    vals = np.array([quantile(spec, (i + 0.5) / n) for i in range(n)])
    if integer:
        vals = np.floor(vals).astype(np.int64)
    return vals[rng.permutation(n)]


def rounds(spec: Dict, n: int, m: int, rng: np.random.Generator,
           integer: bool = True) -> np.ndarray:
    """``n`` draws in rounds of ``m``, each round stratified on its own."""
    return np.concatenate([stratified(spec, min(m, n - lo), rng, integer)
                           for lo in range(0, n, m)])


@dataclasses.dataclass
class Req:
    """One request of a run: its shape, its due time and what it saw."""

    index: int
    prompt: List[int]
    max_new: int
    due: Optional[float] = None      # seconds from its phase's start (open loop)
    due_at: Optional[float] = None   # host monotonic clock: when it was due
    in_window: bool = False
    client: int = -1
    # filled by the harness
    first_t: Optional[float] = None
    token_t: List[float] = dataclasses.field(default_factory=list)
    handle: object = None            # the client's RequestHandle while it runs
    rid: Optional[int] = None        # the program's request id
    output: List[int] = dataclasses.field(default_factory=list)
    state: str = ""

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


def _prompt(seed: int, index: int, length: int, vocab: int) -> List[int]:
    rng = np.random.default_rng([seed, 1, index])
    return rng.integers(0, vocab, size=length).tolist()


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, 0, stream])


class OpenLoop:
    """Poisson arrivals at ``rate``: the pre-roll's and the window's requests."""

    def __init__(self, mix: Dict, cell: Dict, seed: int, seconds: float, vocab: int):
        self.rate = float(cell["rate"])
        self.preroll = self._phase(mix, seed, vocab, float(mix.get("preroll_s", 0.0)),
                                   stream=0, start=-float(mix.get("preroll_s", 0.0)),
                                   first_index=0, in_window=False)
        self.window = self._phase(mix, seed, vocab, seconds, stream=1, start=0.0,
                                  first_index=len(self.preroll), in_window=True)

    def _phase(self, mix, seed, vocab, seconds, stream, start, first_index,
               in_window) -> List[Req]:
        n = int(round(self.rate * seconds))
        if n <= 0:
            return []
        rng = rng_for(int(mix.get("schedule_seed", seed)), stream)
        m = int(mix.get("round", n))
        plens = rounds(mix["prompt_len"], n, m, rng)
        olens = rounds(mix["output_len"], n, m, rng)
        gaps = rounds({"dist": "exponential", "mean": 1.0 / self.rate}, n, m, rng,
                      integer=False)
        # the gaps are scaled to fill the phase: arrivals from `start` on,
        # the last one a gap before its end
        gaps = gaps * (seconds / gaps.sum())
        dues = start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        return [Req(index=first_index + i,
                    prompt=_prompt(seed, first_index + i, int(plens[i]), vocab),
                    max_new=int(olens[i]), due=float(dues[i]), in_window=in_window)
                for i in range(n)]


class ClosedLoop:
    """``clients`` callers, each sending its next request as its last ends.

    ``next_request(client)`` hands out the sizes in the order requests are
    sent; ``pool`` sizes cover far more requests than a run sends.
    """

    POOL_PER_CLIENT = 32

    def __init__(self, mix: Dict, cell: Dict, seed: int, vocab: int):
        self.clients = int(cell["clients"])
        self.seed, self.vocab = seed, vocab
        rng = rng_for(int(mix.get("schedule_seed", seed)), 2)
        n = self.clients * self.POOL_PER_CLIENT
        self.plens = rounds(mix["prompt_len"], n, self.clients, rng)
        self.olens = rounds(mix["output_len"], n, self.clients, rng)
        first_u = (np.arange(self.clients) + 0.5) / self.clients
        self.first_u = first_u[rng.permutation(self.clients)]
        self.first_output = mix.get("first_output")
        self.sent = 0

    def next_request(self, client: int, first: bool) -> Req:
        i = self.sent
        if i >= len(self.plens):
            raise RuntimeError("the closed loop ran out of drawn sizes")
        self.sent += 1
        out = int(self.olens[i])
        if first and self.first_output == "uniform_below":
            out = max(1, int(math.ceil(self.first_u[client] * out)))
        return Req(index=i, prompt=_prompt(self.seed, i, int(self.plens[i]), self.vocab),
                   max_new=out, client=client)
