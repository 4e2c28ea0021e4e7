"""Single-device tensor/expert-parallel execution of the serving paths.
Port of ``repro/distributed/tp.py``.

A ``NodeEngine`` with ``tp_degree > 1`` runs every layer's attention and FFN
as ``tp`` shard computations over parameter slices chosen by the reference's
logical-axis rule walk (``sharding.spec_for`` over
``transformer.param_axes`` with a ``model`` axis of size ``tp``):

* attention — wq/wk/wv sliced on (kv_)heads; each shard runs its heads'
  attention (K4 above ``flash_threshold``, K3 in the paged decode step);
* dense MLP — w_gate/w_up sliced on the mlp dim;
* MoE — router columns and expert slices (expert parallelism; dense
  dispatch only).

Every sliced computation is independent per output column, kv-head or
expert, so the concatenated shard outputs are the full-width intermediate,
and every COMBINE contraction (the output projection's reduce over heads,
``w_down``'s reduce over the mlp dim, the MoE combine's reduce over
experts) runs ONCE over the concatenated operands, never as per-shard
partial sums. The reference gets bit-identical shards by this
construction; on a GPU a shard's narrower GEMM may take another cuBLAS
algorithm (another reduction order), so the bar there is token identity
with logits within a stated tolerance.

All shards live on one device: a shard's parameters are views of the full
tensors (no copies). The merged combine weights (``wo``, and ``w_down`` of a
dense MLP) are the concatenation of the shards' slices; an engine builds
them once with :func:`merged_combine` and passes them to every step.
Embedding and unembedding stay replicated, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.distributed.sharding import DEFAULT_RULES, AbstractMesh, spec_for
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.models.common import ModelConfig, embed, rms_norm
from repro_torch.models.mlp import _act

Params = Dict[str, Any]
Tensor = torch.Tensor

TP_FAMILIES = ("dense", "moe")


def ep_degree(cfg: ModelConfig, tp: int) -> int:
    """Expert-parallel degree implied by a tp degree: MoE configs run their
    experts over the same model axis, everything else has no expert axis."""
    return tp if cfg.family == "moe" else 1


def validate_tp(cfg: ModelConfig, tp: int) -> None:
    """Reject configs the sharded data path cannot run exactly."""
    if tp <= 1:
        return
    if cfg.family not in TP_FAMILIES:
        raise ValueError(f"tensor parallelism supports families {TP_FAMILIES}, "
                         f"got {cfg.family!r}")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"heads ({cfg.num_heads}/{cfg.num_kv_heads}) must "
                         f"divide tp={tp}")
    if cfg.family == "moe":
        if cfg.num_experts % tp:
            raise ValueError(f"experts ({cfg.num_experts}) must divide tp={tp}")
        if cfg.moe_dispatch != "dense" or (cfg.top_k == 1 and
                                           cfg.moe_sparse_dispatch):
            raise ValueError("expert-parallel serving supports dense dispatch "
                             "only (capacity/sparse dispatch reorders tokens "
                             "per shard)")
    elif cfg.d_ff % tp:
        raise ValueError(f"d_ff ({cfg.d_ff}) must divide tp={tp}")


def _walk(params: Params, axes: Params, fn) -> Params:
    if isinstance(params, dict):
        return {k: _walk(v, axes[k], fn) for k, v in params.items()}
    return fn(params, axes)


def shard_params(params: Params, cfg: ModelConfig, tp: int) -> List[Params]:
    """Slice a full parameter tree into ``tp`` shard trees of views.

    Which dim of each tensor is sliced is decided by ``spec_for`` over
    ``param_axes`` — the reference's rule walk — and replicated tensors are
    the same tensor in every shard.
    """
    validate_tp(cfg, tp)
    if tp == 1:
        return [params]
    mesh = AbstractMesh(model=tp)
    axes = dict(TF.param_axes(cfg))
    axes["embed"] = (None, None)        # replicated (see module docstring)
    if "unembed" in axes:
        axes["unembed"] = (None, None)

    def slicer(s: int):
        def one(x: Tensor, ax) -> Tensor:
            spec = spec_for(tuple(x.shape), ax, mesh, DEFAULT_RULES)
            dim = next((i for i, part in enumerate(spec) if part == "model"), None)
            if dim is None:
                return x
            width = x.shape[dim] // tp
            return x.narrow(dim, s * width, width)
        return one

    return [_walk(params, axes, slicer(s)) for s in range(tp)]


def merged_combine(shards: Sequence[Params], cfg: ModelConfig) -> Dict[str, Tensor]:
    """The combine weights as the concatenation of the shards' slices,
    stacked over layers: ``wo`` (L, H, hd, d) and, for a dense MLP,
    ``w_down`` (L, F, d). Their bits are those of the unsharded weights."""
    layers = [sp["layers"] for sp in shards]
    out = {"wo": torch.cat([lp["wo"] for lp in layers], dim=1)}
    if cfg.family != "moe":
        out["w_down"] = torch.cat([lp["w_down"] for lp in layers], dim=1)
    return out


# ---------------------------------------------------------------------------
# Shard-and-merge layer bodies
# ---------------------------------------------------------------------------
def _layer(shards: Sequence[Params], merged: Dict[str, Tensor], i: int):
    return ([TF.layer_params(sp, i) for sp in shards],
            {k: v[i] for k, v in merged.items()})


def _sharded_mlp(lps: Sequence[Params], w_down: Tensor, x: Tensor,
                 cfg: ModelConfig) -> Tensor:
    """Column-parallel SwiGLU: per-shard gate/up, one full-width down."""
    hidden = torch.cat(
        [_act(torch.matmul(x, lp["w_gate"]), cfg.activation)
         * torch.matmul(x, lp["w_up"]) for lp in lps], dim=-1)
    return torch.matmul(hidden, w_down)


def _sharded_moe(moe_ps: Sequence[Params], x: Tensor, cfg: ModelConfig) -> Tensor:
    """Expert-parallel dense-dispatch MoE (mirrors ``moe.moe_ffn``): router
    columns per shard concatenated to the full logits, routing on the full
    tensor, expert matmuls per shard on its experts, and ONE combine over
    the concatenated (E, N, D) expert outputs."""
    logits = torch.cat([torch.einsum("bsd,de->bse", x.float(), p["router"].float())
                        for p in moe_ps], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    combine = MOE.dense_combine(probs, cfg.top_k).to(x.dtype)
    expert_out = torch.cat([MOE.expert_outputs(p, x, cfg.activation) for p in moe_ps],
                           dim=0)
    return MOE.combine_experts(expert_out, combine, x.shape)


def _sharded_ffn(lps: Sequence[Params], merged: Dict[str, Tensor], x: Tensor,
                 cfg: ModelConfig) -> Tensor:
    if cfg.family == "moe":
        moe_ps = [{k[len("moe_"):]: v for k, v in lp.items() if k.startswith("moe_")}
                  for lp in lps]
        return _sharded_moe(moe_ps, x, cfg)
    return _sharded_mlp(lps, merged["w_down"], x, cfg)


def _out_project(merged: Dict[str, Tensor], outs: Sequence[Tensor]) -> Tensor:
    """Concatenated shard head-outputs, ONE output projection."""
    return A.out_project({"wo": merged["wo"]}, torch.cat(list(outs), dim=2))


def _head_slice(arr: Tensor, tp: int, s: int, axis: int) -> Tensor:
    width = arr.shape[axis] // tp
    return arr.narrow(axis, s * width, width)


# ---------------------------------------------------------------------------
# Entry points (twins of transformer.prefill / prefill_suffix /
# decode_step_paged with sharded layer bodies)
# ---------------------------------------------------------------------------
def sharded_prefill(shards: Sequence[Params], cfg: ModelConfig, tokens: Tensor,
                    merged: Optional[Dict[str, Tensor]] = None):
    """Sharded twin of ``transformer.prefill``; returns the FULL-width cache
    (k/v (L, B, S, KV, hd)) so callers slice per shard when writing pools."""
    merged = merged_combine(shards, cfg) if merged is None else merged
    x = embed(tokens, shards[0]["embed"], scale=cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lps, mi = _layer(shards, merged, i)
        hn = rms_norm(x, lps[0]["norm_attn"], cfg.norm_eps)
        parts = [A.self_attention_heads(lp, hn, cfg, positions, cfg.attn_window)
                 for lp in lps]
        x = x + _out_project(mi, [o for o, _ in parts])
        x = x + _sharded_ffn(lps, mi, rms_norm(x, lps[0]["norm_mlp"], cfg.norm_eps), cfg)
        ks.append(torch.cat([kv[0] for _, kv in parts], dim=2))
        vs.append(torch.cat([kv[1] for _, kv in parts], dim=2))
    logits = TF._head(shards[0], cfg, x[:, -1:])
    length = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "length": length}


def sharded_prefill_suffix(shards: Sequence[Params], cfg: ModelConfig, tokens: Tensor,
                           prefix_k: Tensor, prefix_v: Tensor,
                           merged: Optional[Dict[str, Tensor]] = None):
    """Sharded twin of ``transformer.prefill_suffix`` (chunked prefill and
    prefix hits). prefix_k/v are FULL-width (L, B, C, KV, hd); the cache
    returned covers only the suffix."""
    tp = len(shards)
    merged = merged_combine(shards, cfg) if merged is None else merged
    x = embed(tokens, shards[0]["embed"], scale=cfg.embed_scale)
    c = prefix_k.shape[2]
    positions = c + torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lps, mi = _layer(shards, merged, i)
        hn = rms_norm(x, lps[0]["norm_attn"], cfg.norm_eps)
        parts = [A.suffix_attention_heads(lp, hn, cfg, positions,
                                          _head_slice(prefix_k[i], tp, s, 2),
                                          _head_slice(prefix_v[i], tp, s, 2),
                                          cfg.attn_window)
                 for s, lp in enumerate(lps)]
        x = x + _out_project(mi, [o for o, _ in parts])
        x = x + _sharded_ffn(lps, mi, rms_norm(x, lps[0]["norm_mlp"], cfg.norm_eps), cfg)
        ks.append(torch.cat([kv[0] for _, kv in parts], dim=2))
        vs.append(torch.cat([kv[1] for _, kv in parts], dim=2))
    logits = TF._head(shards[0], cfg, x[:, -1:])
    length = torch.full((tokens.shape[0],), c + x.shape[1], dtype=torch.int32,
                        device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "length": length}


def sharded_decode_step_paged(shards: Sequence[Params], cfg: ModelConfig, token: Tensor,
                              pools: Sequence[Tensor], block_tables: Tensor,
                              lengths: Tensor,
                              merged: Optional[Dict[str, Tensor]] = None):
    """Sharded twin of ``transformer.decode_step_paged``.

    ``pools[s]`` is shard s's FLOWKV pool (same blocks and layers, its
    kv-head slice of every payload). Each shard reads its own pages through
    K3 (one launch per shard per layer) and, after the layer stack, appends
    its slice of the batch's new K/V with its own K1 launch. The in-flight
    token's online-softmax merge runs ONCE on the concatenated kernel stats
    (its einsums are not bit-stable across kv-head extents). Returns
    (logits (B, V) fp32, pools), the pools updated in place.
    """
    from repro_torch.kernels.kv_gather import kv_append_tokens
    from repro_torch.kernels.paged_attention import paged_decode_attention

    merged = merged_combine(shards, cfg) if merged is None else merged
    x = embed(token[:, None], shards[0]["embed"], scale=cfg.embed_scale)
    pos = torch.as_tensor(lengths, device=x.device).broadcast_to((x.shape[0],))
    tp = len(shards)
    ks: List[List[Tensor]] = [[] for _ in range(tp)]
    vs: List[List[Tensor]] = [[] for _ in range(tp)]
    for i in range(pools[0].shape[1]):
        lps, mi = _layer(shards, merged, i)
        hn = rms_norm(x, lps[0]["norm_attn"], cfg.norm_eps)
        q1s, k1s, v1s, outs, ms, ls = [], [], [], [], [], []
        for s, (lp, pool) in enumerate(zip(lps, pools)):
            q, k_new, v_new = A.qkv_project(lp, hn, cfg, pos[:, None])
            o, m, l = paged_decode_attention(q[:, 0], pool, i, block_tables, pos,
                                             block_size=cfg.block_size, return_stats=True)
            q1s.append(q[:, 0]), k1s.append(k_new[:, 0]), v1s.append(v_new[:, 0])
            outs.append(o), ms.append(m), ls.append(l)
            ks[s].append(k_new[:, 0])
            vs[s].append(v_new[:, 0])
        merged_out = A.merge_inflight_token(
            torch.cat(q1s, dim=1), torch.cat(k1s, dim=1), torch.cat(v1s, dim=1),
            torch.cat(outs, dim=1), torch.cat(ms, dim=1), torch.cat(ls, dim=1), hn.dtype)
        x = x + A.out_project({"wo": mi["wo"]}, merged_out)
        x = x + _sharded_ffn(lps, mi, rms_norm(x, lps[0]["norm_mlp"], cfg.norm_eps), cfg)
    for s, pool in enumerate(pools):
        kv_append_tokens(pool, block_tables, lengths, torch.stack(ks[s]), torch.stack(vs[s]),
                         block_size=cfg.block_size)
    return TF._head(shards[0], cfg, x), pools
