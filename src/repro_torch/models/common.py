"""Shared model substrate: config schema, RMSNorm, RoPE, embeddings.

Port of ``repro/models/common.py``. Params are plain dicts of tensors with
the reference's layouts: layer parameters stacked on a leading ``layers``
axis; the forward passes loop over that axis in Python where the reference
uses ``jax.lax.scan``. The training half: :func:`softmax_cross_entropy`,
:func:`maybe_remat` (``torch.utils.checkpoint`` per layer), and the param
tree helpers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | granitemoehybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (0/None where attention-free)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_window: int = 0             # 0 = full causal; >0 = local windowed
    use_rope: bool = True            # False: no position embedding (NoPE)
    attn_scale: float = 0.0          # score scale; 0 = 1/sqrt(head_dim)
    # mlp
    d_ff: int = 0
    activation: str = "silu"         # silu (swiglu) | gelu (geglu)
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_experts_held: int = 0        # experts this device holds (0 = all num_experts)
    shared_d_ff: int = 0             # a shared gated expert beside the routed ones
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64
    ssm_conv_bias: bool = False
    # hybrid (recurrentgemma: "rec" | "attn"; granitemoehybrid: "mamba" | "attn"),
    # repeated over the layers
    layer_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    # encoder-decoder
    num_encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub
    frontend: str = "none"
    frontend_tokens: int = 0
    # numerics / serving
    dtype: Any = torch.bfloat16      # a torch dtype (the reference types it with jnp)
    block_size: int = 32             # KV page size (tokens)
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma-style sqrt(d_model) input scale
    embed_multiplier: float = 1.0    # granite: embeddings x this
    residual_multiplier: float = 1.0  # granite: each residual branch x this
    logits_scaling: float = 1.0      # granite: logits / this
    state_slots: int = 0             # state slots a node holds (granitemoehybrid)
    norm_eps: float = 1e-6
    # attention impl knobs
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    attn_wedge: bool = False         # exact-causal unrolled flash (training; models/flash.py)
    flash_threshold: int = 1024      # prefill attention takes K4 above this length
    moe_sparse_dispatch: bool = False
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25
    remat: str = "none"              # none | full | dots — per-layer checkpointing (training)
    tp_reduce_bf16: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """SSM, or hybrid with a bounded attention window."""
        return self.family == "ssm" or (self.family == "hybrid" and self.attn_window > 0)

    def kv_bytes_per_token(self) -> int:
        """KV-cache bytes per token (what the P->D transfer moves)."""
        if self.family == "ssm":
            return 0
        return 2 * self.num_attention_layers() * self.num_kv_heads * \
            self.head_dim * self.dtype.itemsize

    def num_attention_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family in ("hybrid", "granitemoehybrid") and self.layer_pattern:
            return self.layer_kinds().count("attn")
        return self.num_layers

    def layer_kinds(self) -> Tuple[str, ...]:
        """Each layer's mixer, ``layer_pattern`` repeated over the depth."""
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def experts_held(self) -> int:
        return self.moe_experts_held or self.num_experts

    def state_slot_bytes(self) -> int:
        """Bytes of one request's state slot (the granitemoehybrid family's
        Mamba-2 layers: fp32 h and the conv tail in the served type); 0 for
        a family that holds no slot."""
        if self.family != "granitemoehybrid":
            return 0
        layers = self.layer_kinds().count("mamba")
        h = self.ssm_heads * self.ssm_head_dim * self.ssm_state * 4
        tail = (self.ssm_conv - 1) * (self.ssm_d_inner + 2 * self.ssm_state) \
            * self.dtype.itemsize
        return layers * (h + tail)

    def num_params(self) -> int:
        """Analytic parameter count (the reference's, family by family)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d
        if self.family == "granitemoehybrid":
            return emb + sum(self._granite_layer_params(k) for k in self.layer_kinds())
        if self.family == "ssm":
            di, n, h = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * n + h) + di * d + di + h  # in/x/B/C/dt proj + out
            return emb + self.num_layers * per
        attn = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim \
            + self.num_heads * self.head_dim * d
        if self.family == "moe":
            ff = self.num_experts * 3 * d * (self.moe_d_ff or self.d_ff) + d * self.num_experts
        else:
            ff = 3 * d * self.d_ff
        per = attn + ff
        if self.family == "hybrid":
            rec = 3 * d * self.lru_width + 2 * self.lru_width  # coarse RG-LRU block
            n_attn = self.num_attention_layers()
            return emb + n_attn * per + (self.num_layers - n_attn) * (rec + 3 * d * self.d_ff)
        if self.family == "encdec":
            cross = d * self.num_heads * self.head_dim * 2 + 2 * d * self.num_kv_heads * self.head_dim
            return emb + self.num_encoder_layers * per + self.num_layers * (per + cross)
        return emb + self.num_layers * per

    def _granite_layer_params(self, kind: str) -> int:
        """One granitemoehybrid layer: its mixer and the MoE this device
        holds (router, held experts, shared expert); norms and gains left out."""
        d, di, n, h = self.d_model, self.ssm_d_inner, self.ssm_state, self.ssm_heads
        if kind == "mamba":
            mixer = d * (2 * di + 2 * n + h) + di * d + self.ssm_conv * (di + 2 * n)
        else:
            mixer = 2 * d * self.num_heads * self.head_dim \
                + 2 * d * self.num_kv_heads * self.head_dim
        return mixer + d * self.num_experts + 3 * d * (
            self.experts_held * self.moe_d_ff + self.shared_d_ff)

    def active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family == "granitemoehybrid":
            # a token runs top_k x held / num_experts of the held experts
            idle = self.experts_held - self.top_k * self.experts_held / self.num_experts
            return self.num_params() - int(self.num_layers * idle * 3 * self.d_model
                                           * self.moe_d_ff)
        if self.family != "moe":
            return self.num_params()
        d = self.d_model
        per_expert = 3 * d * (self.moe_d_ff or self.d_ff)
        return self.num_params() - self.num_layers * (self.num_experts - self.top_k) * per_expert


# ---------------------------------------------------------------------------
# Initializers (explicit torch.Generator; no claim to reproduce jax.random)
# ---------------------------------------------------------------------------
def make_generator(dev: torch.device, seed: int) -> Optional[torch.Generator]:
    """A generator on ``dev`` seeded with ``seed``; None on the meta device,
    where :func:`dense_init` makes shapes only (``abstract_train_state``)."""
    if dev.type == "meta":
        return None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def dense_init(gen: Optional[torch.Generator], shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return out.mul_(s).to(dtype)


# ---------------------------------------------------------------------------
# Normalization / positional encodings
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(dtype)


_ROPE_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, hd, 2) / hd)`` in fp32 (hd/2,), built once
    per ``(head_dim, theta, device)`` on that device and reused: the build
    copies ``theta`` from the host, which on a GPU waits for the stream, and
    a forward that makes no such copy can be captured as a CUDA graph. The
    cached tensor is shared: callers must not write to it."""
    dev = torch.device("cpu" if device is None else device)
    key = (head_dim, float(theta), dev)
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        # a plain tensor whatever the caller's mode, so that training can
        # reuse one built under inference_mode
        with torch.inference_mode(False), torch.no_grad():
            exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim
            freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=dev), exps)
        _ROPE_FREQS[key] = freqs
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool = False) -> torch.Tensor:
    out = table[tokens.long()]
    if scale:  # gemma-style sqrt(d) embedding scale, rounded to the table dtype
        out = out * torch.tensor(out.shape[-1] ** 0.5, dtype=out.dtype)
    return out


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, table.t()).float()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL. logits (..., vocab) fp32; labels int (...); the
    optional mask weights each token and divides by ``max(mask.sum(), 1)``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# Activation checkpointing
# ---------------------------------------------------------------------------
# ``remat="dots"`` keeps the outputs of the weight GEMMs — ``torch.matmul``
# of activations (B, S, D) by a weight (D, F) dispatches to aten.mm — and
# recomputes everything else, the attention's batched einsums (aten.bmm)
# included: JAX's ``checkpoint_dots_with_no_batch_dims``.
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(body: Callable, cfg: ModelConfig) -> Callable:
    """Wrap one layer's (or one griffin group's) function with activation
    checkpointing per ``cfg.remat``: ``full`` saves only its inputs and
    recomputes the whole layer in backward; ``dots`` also saves the weight
    GEMMs' outputs. ``body`` takes the layer's own (unbound) leaves, never
    the stacked tensors, so a recompute re-slices nothing."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if cfg.remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(checkpoint, body, use_reentrant=False, context_fn=ctx)
    if cfg.remat != "none":
        raise ValueError(f"unknown remat mode {cfg.remat!r}")
    return body


# ---------------------------------------------------------------------------
# Param-tree helpers
# ---------------------------------------------------------------------------
def unbind_layers(stack: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Each layer's leaves from a dict of stacked ``(L, ...)`` leaves, taken
    apart once with ``torch.unbind``: its backward is one ``stack`` a leaf,
    where indexing ``leaf[i]`` per layer would add into a zeroed tensor of
    the whole stack once a layer."""
    names = list(stack)
    return [dict(zip(names, leaves))
            for leaves in zip(*(torch.unbind(stack[n], 0) for n in names))]


def count_params(params: Dict[str, Any]) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def cast_params(params, dtype):
    """Every floating leaf cast to ``dtype`` (others as they are)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts in ``jax.tree.leaves``' order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves):
    """Nested dicts of ``template``'s structure holding ``leaves``, in
    :func:`tree_leaves`' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (and parallel trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
