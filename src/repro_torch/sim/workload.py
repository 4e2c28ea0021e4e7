"""Workload generation: Poisson arrivals + the paper's request mixes.

* Simulated data (Tables 1-2): fixed input length (1K/5K/10K), output 256.
* Real-world proxy (Fig. 4): LongBench summarization subtask length
  profiles — gov_report / multi_news / qmsum input-length distributions
  (means taken from the published dataset statistics) with summary-length
  outputs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Request, SamplingParams


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    mean_input: int
    mean_output: int
    input_std: float = 0.0        # 0 => fixed length
    output_std: float = 0.0
    num_requests: int = 100


# paper §4.1: simulated sets
SIMULATED = {
    "1k": WorkloadSpec("sim-1k", 1024, 256),
    "5k": WorkloadSpec("sim-5k", 5120, 256),
    "10k": WorkloadSpec("sim-10k", 10240, 256),
}

# LongBench summarization subtasks (token-length profiles)
LONGBENCH = {
    "gov_report": WorkloadSpec("gov_report", 8734, 512, input_std=3000, output_std=120),
    "multi_news": WorkloadSpec("multi_news", 2113, 256, input_std=1200, output_std=80),
    "qmsum": WorkloadSpec("qmsum", 10614, 256, input_std=2500, output_std=60),
}


def generate(spec: WorkloadSpec, rps: float, seed: int = 0,
             vocab_size: int = 32000) -> List[Request]:
    """Poisson arrival process at `rps`; token ids are synthetic."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / max(rps, 1e-9), size=spec.num_requests)
    arrivals = np.cumsum(gaps)
    out: List[Request] = []
    for i in range(spec.num_requests):
        ilen = spec.mean_input if spec.input_std == 0 else max(
            16, int(rng.normal(spec.mean_input, spec.input_std)))
        olen = spec.mean_output if spec.output_std == 0 else max(
            8, int(rng.normal(spec.mean_output, spec.output_std)))
        # token ids only matter for prefix-cache hashing; randomize
        prompt = rng.randint(0, vocab_size, size=ilen).tolist()
        out.append(Request(
            prompt_tokens=prompt,
            sampling=SamplingParams(max_new_tokens=olen),
            arrival_time=float(arrivals[i]),
        ))
    return out


def generate_conversations(num_conversations: int, turns: int, rps: float,
                           *, first_turn_tokens: int = 1024,
                           user_turn_tokens: int = 128,
                           output_tokens: int = 128,
                           think_time_s: float = 2.0, seed: int = 0,
                           vocab_size: int = 32000) -> List[Request]:
    """Multi-turn chat traffic: turn ``k``'s prompt is turn ``k-1``'s prompt
    + its generated output + a fresh user message.

    This is the workload the tiered KV store exists for — every turn
    re-submits the whole conversation history, so the shared prefix GROWS
    per turn and stays valuable across the think-time gap (long enough for
    capacity pressure to demote it to host DRAM between turns).

    Conversation STARTS are a Poisson process at ``rps``; turns within a
    conversation are spaced ``think_time_s`` apart. The simulator emits
    token id 0 for every generated token, so histories append ``[0] *
    output_tokens`` — digest-exact with what the virtual decode produced.
    """
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / max(rps, 1e-9), size=num_conversations)
    starts = np.cumsum(gaps)
    out: List[Request] = []
    for c in range(num_conversations):
        history = rng.randint(0, vocab_size,
                              size=first_turn_tokens).tolist()
        t = float(starts[c])
        for _ in range(turns):
            out.append(Request(
                prompt_tokens=list(history),
                sampling=SamplingParams(max_new_tokens=output_tokens),
                arrival_time=t,
            ))
            history = (history + [0] * output_tokens +
                       rng.randint(0, vocab_size,
                                   size=user_turn_tokens).tolist())
            t += think_time_s
    out.sort(key=lambda r: r.arrival_time)
    return out


def generate_mixture(specs: Sequence[WorkloadSpec], weights: Sequence[float],
                     rps: float, num_requests: int, seed: int = 0,
                     vocab_size: int = 32000) -> List[Request]:
    """One Poisson arrival stream whose per-request shape is drawn from a
    weighted mix of specs — e.g. the computationally-imbalanced scenario
    mixes long-prompt/short-output (prefill-heavy) with short-prompt/
    long-output (decode-heavy) traffic in one stream.
    """
    if len(specs) != len(weights):
        raise ValueError("specs and weights must have the same length")
    rng = np.random.RandomState(seed)
    probs = np.asarray(weights, dtype=float)
    probs = probs / probs.sum()
    gaps = rng.exponential(1.0 / max(rps, 1e-9), size=num_requests)
    arrivals = np.cumsum(gaps)
    picks = rng.choice(len(specs), size=num_requests, p=probs)
    out: List[Request] = []
    for i in range(num_requests):
        spec = specs[picks[i]]
        ilen = spec.mean_input if spec.input_std == 0 else max(
            16, int(rng.normal(spec.mean_input, spec.input_std)))
        olen = spec.mean_output if spec.output_std == 0 else max(
            8, int(rng.normal(spec.mean_output, spec.output_std)))
        prompt = rng.randint(0, vocab_size, size=ilen).tolist()
        out.append(Request(
            prompt_tokens=prompt,
            sampling=SamplingParams(max_new_tokens=olen),
            arrival_time=float(arrivals[i]),
        ))
    return out
