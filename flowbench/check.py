"""How ``correct`` is decided: the served tokens of a sample of the requests
the window finished, held against the plain reference.

The sample is drawn from the seed and always holds the longest finished
request (prompt and output). The reference runs once over each sampled
prompt followed by its served tokens (teacher forced), in float32, and at
each served position reads how far the served token's logit lies below the
reference's best there. The number compared is the widest such gap; its
limit is the cell's ``check.limit`` (PERF.md gives the readings it was set
from). A request served fewer or more tokens than it asked for is counted
apart, with the limit 0.

With ``control=True`` the control is also put in the program's place: the
reference with fp8 linear layers (``quant="fp8"``) picks the token at each
of the same positions, and the gap of its pick is judged by the same numbers
and limits through ``passed``. The benchmark's runs never ask for it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Served = Tuple[List[int], List[int], int]      # prompt, served tokens, asked for


def sample(served: Sequence[Served], seed: int, tokens: int, budget: int) -> List[int]:
    """Indices of the requests to compare: the longest, then others in an
    order drawn from ``seed`` until ``tokens`` served tokens are covered or
    the reference's ``budget`` of sequence tokens would be passed."""
    if not served:
        return []
    size = [len(p) + len(o) for p, o, _ in served]
    longest = int(np.argmax(size))
    order = [longest] + [int(i) for i in np.random.default_rng([seed, 3]).permutation(
        len(served)) if i != longest]
    picked, n_tok, n_seq = [], 0, 0
    for i in order:
        if picked and (n_tok >= tokens or n_seq + size[i] > budget):
            break
        picked.append(i)
        n_tok += len(served[i][1])
        n_seq += size[i]
    return picked


def gaps(ref, params, cfg: Dict, prompt: List[int], out: List[int],
         quant=None) -> Tuple[np.ndarray, np.ndarray]:
    """Per served token: the reference's best logit minus the served token's,
    and (with ``quant``) minus the logit of the token the control puts first."""
    import torch

    seq = prompt + out[:-1]
    rows = range(len(prompt) - 1, len(seq))
    logits = ref.logits_at(params, cfg, seq, rows)
    best = logits.max(dim=-1).values
    served = torch.as_tensor(out, device=logits.device)
    gap = (best - logits.gather(1, served[:, None])[:, 0]).cpu().numpy()
    ctrl = np.zeros(0)
    if quant is not None:
        pick = ref.logits_at(params, cfg, seq, rows, quant=quant).argmax(dim=-1)
        ctrl = (best - logits.gather(1, pick[:, None])[:, 0]).cpu().numpy()
    return gap, ctrl


def judge(ref, params, cfg: Dict, limits: Dict, served: Sequence[Served], seed: int,
          control: bool = False) -> Tuple[Dict[str, Dict], Optional[Dict[str, Dict]]]:
    """The numbers compared, each with its limit (and readings without one),
    for the program and, with ``control``, for the control in its place."""
    t0 = time.monotonic()
    idx = sample(served, seed, limits["tokens"], limits["budget"])
    g_all, c_all, n_tok, distinct = [], [], 0, 0
    for i in idx:
        prompt, out, _ = served[i]
        g, c = gaps(ref, params, cfg, prompt, out, quant="fp8" if control else None)
        g_all.append(g)
        c_all.append(c)
        n_tok += len(out)
        distinct += len(set(out))
    miscounted = sum(1 for _, o, n in served if len(o) != n)
    checks = readings(g_all, limits, n_tok, miscounted)
    checks.update(requests_compared={"value": len(idx)},
                  distinct_token_share={"value": distinct / max(1, n_tok)},
                  reference_s={"value": time.monotonic() - t0})
    # the control serves what it was asked for: it is read at the same positions
    return checks, readings(c_all, limits, n_tok, 0) if control else None


def readings(gap_arrays: List[np.ndarray], limits: Dict, n_tok: int,
             miscounted: int) -> Dict[str, Dict]:
    """The numbers with a limit, from the gaps of the tokens judged."""
    g = np.concatenate(gap_arrays) if gap_arrays else np.zeros(1)
    return {
        "max_logit_gap": {"value": float(g.max()), "limit": limits["limit"]},
        "tokens_compared": {"value": n_tok, "limit": limits["min_tokens"], "at_least": True},
        "requests_miscounted": {"value": miscounted, "limit": 0},
        "mean_logit_gap": {"value": float(g.mean())},
        "off_argmax_share": {"value": float((g > 0).mean())},
    }


def passed(checks: Dict[str, Dict]) -> bool:
    """Every number with a limit within it (``at_least``: at or above)."""
    return all(c["value"] >= c["limit"] if c.get("at_least") else c["value"] <= c["limit"]
               for c in checks.values() if "limit" in c)
