"""Mixture-of-Experts FFN with top-k routing. Port of ``repro/models/moe.py``.

Four dispatches, each returning ``(out (B, S, D), aux_loss)`` with the
reference's Switch-style load-balancing loss:

* :func:`moe_ffn` — dense dispatch (the default): every expert sees every
  token and a one-hot ``(B, S, E)`` combine keeps the top-k. The experts
  run as one batched matmul over the expert axis, so the expert weights are
  read in place (no permuted copy), and the combine reduces over experts
  once. ``distributed/tp.py`` runs the same expert compute per shard on its
  expert slice and this combine once over the concatenated outputs.
* :func:`moe_ffn_gshard` — capacity-based gather/scatter dispatch.
* :func:`moe_ffn_gshard_einsum` — the one-hot einsum form of the same.
* :func:`moe_ffn_topk_sparse` — top-1 routing. The reference gathers a
  ``(B, S, D, F)`` weight per token; here tokens are grouped by their expert
  and each group runs that expert's matmuls, the same per-token function
  (the gathered form would hold three 126 GB weights at llama4-scout's
  widths and 1500 tokens in bf16).

The reference writes no kernel for MoE: these are plain torch ops.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.mlp import _act

Tensor = torch.Tensor


def moe_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    e = cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    return {
        "router": (d, e),
        "w_gate": (e, d, f),
        "w_up": (e, d, f),
        "w_down": (e, f, d),
    }


def moe_param_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "embed", "mlp"),
        "w_up": ("experts", "embed", "mlp"),
        "w_down": ("experts", "mlp", "embed"),
    }


def router_probs(x: Tensor, router: Tensor) -> Tensor:
    """fp32 softmax over the experts of ``x @ router``: (B, S, E)."""
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    return torch.softmax(logits, dim=-1)


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    top_p, top_idx = torch.topk(probs, k, dim=-1)
    return top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), top_idx


def dense_combine(probs: Tensor, k: int) -> Tensor:
    """The top-k's normalised weights as a dense (B, S, E) fp32 tensor, 0
    off the top-k."""
    top_p, top_idx = _top_k(probs, k)
    return torch.zeros_like(probs).scatter(-1, top_idx, top_p)


def expert_outputs(p: Dict[str, Tensor], x: Tensor, activation: str) -> Tensor:
    """Every expert of ``p`` on every token: x (B, S, D) -> (E, B*S, D).

    One batched matmul per weight over the expert axis; ``w_*`` (E, ...)
    may be an expert slice (a shard's experts)."""
    x2 = x.reshape(-1, x.shape[-1])
    gate = _act(torch.matmul(x2, p["w_gate"]), activation)      # (E, N, F)
    up = torch.matmul(x2, p["w_up"])
    return torch.matmul(gate * up, p["w_down"])                 # (E, N, D)


def combine_experts(expert_out: Tensor, combine: Tensor, shape) -> Tensor:
    """out[n] = sum_e combine[n, e] * expert_out[e, n]: ONE reduction over
    all experts. expert_out (E, N, D), combine (B, S, E) in its dtype."""
    b, s, d = shape
    out = torch.einsum("end,ne->nd", expert_out, combine.reshape(b * s, -1))
    return out.reshape(b, s, d)


def switch_aux(density: Tensor, probs: Tensor, num_experts: int) -> Tensor:
    return num_experts * torch.sum(density * probs.mean(dim=(0, 1)))


def moe_ffn(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Dense dispatch: x (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    probs = router_probs(x, p["router"])
    combine = dense_combine(probs, cfg.top_k).to(x.dtype)
    out = combine_experts(expert_outputs(p, x, cfg.activation), combine, x.shape)
    density = combine.float().mean(dim=(0, 1))
    return out, switch_aux(density, probs, cfg.num_experts)


def moe_share_ffn(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                  first: int = 0) -> Tensor:
    """One device's share of an expert-parallel layer, dense dispatch: the
    router keeps all ``num_experts`` outputs and its top-k (a softmax over
    the top-k logits, the same as the top-k of the full softmax
    renormalised), and the layer computes only the part of the result that
    the experts it holds give. ``p["w_*"]`` hold experts ``first ..
    first + E_held - 1``; what the absent experts would add is left out.
    x (B, S, D) -> (B, S, D). Static shapes: every held expert sees every
    token, and the combine keeps the routed ones."""
    held = p["w_gate"].shape[0]
    combine = dense_combine(router_probs(x, p["router"]), cfg.top_k)
    combine = combine[..., first:first + held].to(x.dtype)
    return combine_experts(expert_outputs(p, x, cfg.activation), combine, x.shape)


def _capacity(s: int, cfg: ModelConfig, capacity_factor: float) -> int:
    return max(1, int(s * cfg.top_k * capacity_factor / cfg.num_experts))


def moe_ffn_gshard(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                   capacity_factor: float = 1.25) -> Tuple[Tensor, Tensor]:
    """Capacity-based gather/scatter dispatch: each expert takes at most
    ``C = max(1, int(S * top_k * capacity_factor / E))`` tokens a sequence in
    arrival order (overflow falls back to the residual path); tokens are
    gathered into (B, E, C, D) buffers and the results scatter-added back."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = _capacity(s, cfg, capacity_factor)
    probs = router_probs(x, p["router"])
    top_p, top_idx = _top_k(probs, k)

    onehot = F.one_hot(top_idx, e)                                # (B,S,k,E)
    flat = onehot.reshape(b, s * k, e)
    pos_flat = torch.cumsum(flat, dim=1) - 1
    pos = torch.where(flat > 0, pos_flat, torch.zeros_like(pos_flat)).amax(-1)
    pos = pos.reshape(b, s, k)
    slot = torch.where(pos < cap, pos, torch.full_like(pos, cap))  # cap = dropped

    b_idx = torch.arange(b, device=x.device)[:, None, None].expand(b, s, k)
    tok = torch.arange(s, device=x.device)[None, :, None].expand(b, s, k)
    # one spare slot column takes the overflow and is cut off (the
    # reference's mode="drop")
    slot_tok = torch.zeros((b, e, cap + 1), dtype=torch.long, device=x.device)
    slot_tok[b_idx, top_idx, slot] = tok
    slot_w = torch.zeros((b, e, cap + 1), dtype=torch.float32, device=x.device)
    slot_w[b_idx, top_idx, slot] = top_p
    slot_tok, slot_w = slot_tok[..., :cap], slot_w[..., :cap]

    idx = slot_tok.reshape(b, e * cap, 1).expand(b, e * cap, d)
    xin = torch.gather(x, 1, idx).reshape(b, e, cap, d)
    gate = _act(torch.einsum("becd,edf->becf", xin, p["w_gate"]), cfg.activation)
    up = torch.einsum("becd,edf->becf", xin, p["w_up"])
    out_e = torch.einsum("becf,efd->becd", gate * up, p["w_down"])
    out_e = out_e * slot_w[..., None].to(out_e.dtype)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    out.scatter_add_(1, idx, out_e.reshape(b, e * cap, d).to(x.dtype))

    density = onehot.float().sum(2).mean(dim=(0, 1))
    return out, switch_aux(density / k, probs, e)


def moe_ffn_gshard_einsum(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                          capacity_factor: float = 1.25) -> Tuple[Tensor, Tensor]:
    """GShard's one-hot einsum dispatch: the same capacity semantics as
    :func:`moe_ffn_gshard`, expressed against a (B, S, E, C) one-hot."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = _capacity(s, cfg, capacity_factor)
    probs = router_probs(x, p["router"])
    top_p, top_idx = _top_k(probs, k)

    assigned = F.one_hot(top_idx, e).to(probs.dtype)               # (B,S,k,E)
    gate_se = torch.einsum("bske,bsk->bse", assigned, top_p)
    mask_se = assigned.sum(2)                                      # 0/1 (B,S,E)
    pos = torch.cumsum(mask_se, dim=1) * mask_se - 1.0
    keep = (pos >= 0) & (pos < cap)
    slot = torch.where(keep, pos, torch.full_like(pos, cap)).long()
    pos_c = F.one_hot(slot, cap + 1)[..., :cap].to(x.dtype)        # slot cap -> all 0
    dispatch = pos_c * keep[..., None].to(x.dtype)                 # (B,S,E,C)
    combine = dispatch * gate_se[..., None].to(x.dtype)

    xin = torch.einsum("bsd,bsec->becd", x, dispatch)
    gate = _act(torch.einsum("becd,edf->becf", xin, p["w_gate"]), cfg.activation)
    up = torch.einsum("becd,edf->becf", xin, p["w_up"])
    out_e = torch.einsum("becf,efd->becd", gate * up, p["w_down"])
    out = torch.einsum("becd,bsec->bsd", out_e, combine)

    density = mask_se.mean(dim=(0, 1))
    return out, switch_aux(density / k, probs, e)


def host_routed(cfg: ModelConfig) -> bool:
    """Whether the model's FFN takes :func:`moe_ffn_topk_sparse`, which reads
    the router's expert ids on the host to group tokens: its shapes follow
    the data, so a forward through it cannot be captured as a CUDA graph."""
    return cfg.family == "moe" and cfg.top_k == 1 and cfg.moe_sparse_dispatch


def moe_ffn_topk_sparse(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig
                        ) -> Tuple[Tensor, Tensor]:
    """Top-1 routing: each token runs only its argmax expert, scaled by that
    expert's probability. Tokens are grouped by expert (see module
    docstring); each token's row is the reference's per-token function."""
    assert cfg.top_k == 1
    b, s, d = x.shape
    probs = router_probs(x, p["router"])
    idx = torch.argmax(probs, dim=-1)                              # (B,S)
    x2 = x.reshape(-1, d)
    flat_idx = idx.reshape(-1)
    out = torch.zeros_like(x2)
    if x.is_meta:
        # The dry-run has no routing to group by: whatever the routing, the
        # B*S tokens run through one expert each, so price them as one group.
        groups = [(0, torch.arange(x2.shape[0], device=x.device))]
    else:
        groups = [(ex, torch.nonzero(flat_idx == ex).squeeze(1))
                  for ex in torch.unique(flat_idx).tolist()]
    for ex, rows in groups:
        xs = x2.index_select(0, rows)
        gate = _act(xs @ p["w_gate"][ex], cfg.activation)
        out.index_copy_(0, rows, (gate * (xs @ p["w_up"][ex])) @ p["w_down"][ex])
    top_p = torch.gather(probs, -1, idx[..., None]).to(x.dtype)
    out = out.reshape(b, s, d) * top_p
    density = F.one_hot(idx, cfg.num_experts).float().mean(dim=(0, 1))
    return out, switch_aux(density, probs, cfg.num_experts)
