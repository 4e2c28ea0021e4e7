"""Plain PyTorch reference of Granite 4.0-H (``granitemoehybrid``,
hf:ibm-granite/granite-4.0-h-small), written from the published equations
and the port's parameter layout. It imports nothing of the program.

The model: ``x = embed(tokens) * embedding_multiplier``; each layer adds
``residual_multiplier`` x its mixer of ``RMSNorm(x)`` (a Mamba-2 mixer, or
GQA attention without position embedding at the score scale
``attention_multiplier``), then ``residual_multiplier`` x (the routed MoE
plus the shared SwiGLU expert) of ``RMSNorm(x)``; the logits are the tied
unembedding of ``RMSNorm(x)`` over ``logits_scaling``.

* Mamba-2: z, x, B, C, dt projections (no bias), a causal depthwise conv of
  ``mamba_d_conv`` taps with a bias over x, B and C, then silu;
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD recurrence
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t + D x_t``,
  computed in chunks of ``mamba_chunk_size`` (the within-chunk quadratic
  form plus the carried state); ``out = W_out RMSNorm(y * silu(z))`` (the
  gated norm over all of d_inner: one group).
* The router: softmax over the top-k of its logits (Granite's
  ``TopKGating``); each token runs through its routed experts only.

:func:`make_weights` makes the weights on the device from a seed, one
``randn`` a layer slice of each leaf, in the port's layout and served type;
:func:`logits_at` runs float32 everywhere with TF32 off, no cache, no
batching, attention in blocks of query rows. ``quant="fp8"`` is the control:
every linear layer's weight (per output channel) and input (per row)
rounded to fp8 e4m3 before an fp32 product, the precision step below bf16.

Departures from the published model, each a choice of this benchmark:

* **The expert share.** Only experts 0 .. E_held - 1 (the file's
  ``num_local_experts``) are held and computed, as on one card of the
  file's ``deployment``; the router keeps the published count
  (``published.num_local_experts``) and its top-k, and what the absent
  experts would add is left out of the layer's result.
* **Random weights** (the published weights are not used): matrices at
  their fan-in, the embedding at the file's ``init.embed_std``, norm gains
  0 (norms store ``1 + gain``), and the Mamba-2 parameters as Mamba-2's own
  initialisation draws them: ``A_log`` = log(1..H), ``D`` 1, ``dt_bias``
  the inverse softplus of a dt drawn log-uniform in [0.001, 0.1], the conv
  taps and biases uniform in +-1/sqrt(taps).
* The recurrent state ``h`` is fp32 (the published config does not say).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
Q_ROWS = 1024          # query rows a block of attention
FP8 = torch.float8_e4m3fn


def dims(cfg: Dict) -> Dict[str, int]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kinds = cfg["layer_types"]
    heads, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    return {"L": cfg["num_hidden_layers"], "Lm": kinds.count("mamba"),
            "La": kinds.count("attention"), "d": d, "H": h,
            "KV": cfg["num_key_value_heads"], "hd": cfg.get("head_dim") or d // h,
            "V": cfg["vocab_size"], "ff": cfg["intermediate_size"],
            "fs": cfg["shared_intermediate_size"], "E": cfg["published"]["num_local_experts"],
            "Eh": cfg["num_local_experts"], "k": cfg["num_experts_per_tok"],
            "mh": heads, "P": p, "di": heads * p, "N": cfg["mamba_d_state"],
            "cw": cfg["mamba_d_conv"], "Q": cfg["mamba_chunk_size"]}


def shapes(cfg: Dict) -> Dict[str, Dict[str, tuple]]:
    """Every stacked leaf's shape by group, in the port's layout."""
    m = dims(cfg)
    L, Lm, La, d = m["L"], m["Lm"], m["La"], m["d"]
    di, n, mh, cw = m["di"], m["N"], m["mh"], m["cw"]
    layers = {"norm_mixer": (L, d), "norm_ffn": (L, d), "moe_router": (L, d, m["E"]),
              "moe_w_gate": (L, m["Eh"], d, m["ff"]), "moe_w_up": (L, m["Eh"], d, m["ff"]),
              "moe_w_down": (L, m["Eh"], m["ff"], d), "shared_w_gate": (L, d, m["fs"]),
              "shared_w_up": (L, d, m["fs"]), "shared_w_down": (L, m["fs"], d)}
    mamba = {"w_z": (Lm, d, di), "w_x": (Lm, d, di), "w_B": (Lm, d, n), "w_C": (Lm, d, n),
             "w_dt": (Lm, d, mh), "conv_x": (Lm, cw, di), "conv_B": (Lm, cw, n),
             "conv_C": (Lm, cw, n), "A_log": (Lm, mh), "D": (Lm, mh), "dt_bias": (Lm, mh),
             "norm": (Lm, di), "w_out": (Lm, di, d)}
    if cfg.get("mamba_conv_bias"):
        mamba.update(conv_bias_x=(Lm, di), conv_bias_B=(Lm, n), conv_bias_C=(Lm, n))
    attn = {"wq": (La, d, m["H"], m["hd"]), "wk": (La, d, m["KV"], m["hd"]),
            "wv": (La, d, m["KV"], m["hd"]), "wo": (La, m["H"], m["hd"], d)}
    return {"layers": layers, "mamba": mamba, "attn": attn}


def _fan_in(name: str, shape: tuple) -> int:
    """The inputs a matrix's output sums over (the stacked axis first)."""
    if name == "wo":
        return shape[1] * shape[2]
    if name in ("wq", "wk", "wv"):
        return shape[1]
    return shape[-2]


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """Random weights from ``seed`` on ``device``: matrices at their fan-in
    ``** -0.5`` (attention's ``wq`` over d, ``wo`` over H hd), the embedding
    at ``init.embed_std``, norm gains 0; Mamba-2's conv taps and biases
    uniform in +-1/sqrt(taps), ``A_log`` log(1..H), ``D`` 1, ``dt_bias`` the
    inverse softplus of dt = exp(U(log 0.001, log 0.1)). One draw a layer
    slice of each leaf, in a fixed order."""
    dev = torch.device(device)
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    m = dims(cfg)
    bound = m["cw"] ** -0.5

    def draw(shape, scale, uniform=False):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            if uniform:
                r = torch.rand(shape[1:], generator=gen, device=dev).mul_(2).sub_(1)
            else:
                r = torch.randn(shape[1:], generator=gen, device=dev, dtype=torch.float32)
            out[i] = r.mul_(scale).to(dtype)
        return out

    out = {}
    for group, leaves in shapes(cfg).items():
        g = {}
        for name, s in leaves.items():
            if name.startswith("norm"):
                g[name] = torch.zeros(s, dtype=dtype, device=dev)
            elif name == "A_log":
                g[name] = torch.log(torch.arange(1, s[1] + 1, dtype=torch.float32,
                                                 device=dev)).expand(s).contiguous()
            elif name == "D":
                g[name] = torch.ones(s, dtype=dtype, device=dev)
            elif name == "dt_bias":
                u = torch.rand(s, generator=gen, device=dev)
                dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
                g[name] = dt + torch.log(-torch.expm1(-dt))
            elif name.startswith("conv"):
                g[name] = draw(s, bound, uniform=True)
            else:
                g[name] = draw(s, _fan_in(name, s) ** -0.5)
        out[group] = g
    emb = torch.randn((m["V"], m["d"]), generator=gen, device=dev, dtype=torch.float32)
    out["embed"] = emb.mul_(cfg["init"]["embed_std"]).to(dtype)
    out["final_norm"] = torch.zeros(m["d"], dtype=dtype, device=dev)
    return out


# ---------------------------------------------------------------------------
# The forward, in float32
# ---------------------------------------------------------------------------
def _rms(x: Tensor, gain: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + gain.float())


def _linear(x: Tensor, w: Tensor, quant: Optional[str]) -> Tensor:
    """x (N, i) @ w (i, o) in fp32; under ``quant="fp8"`` both operands are
    rounded to e4m3 first (w per output column, x per row)."""
    w = w.float()
    if quant == "fp8":
        x = _fp8(x, dim=-1)
        w = _fp8(w, dim=0)
    elif quant is not None:
        raise ValueError(f"unknown control precision {quant!r}")
    return x @ w


def _fp8(t: Tensor, dim: int) -> Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = torch.finfo(FP8).max / amax
    return (t * scale).to(FP8).float() / scale


def _conv(x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tensor:
    """Causal depthwise conv over time, zeros before the first token:
    out[t] = sum_i w[i] x[t - (cw-1) + i] (+ b), then silu. x (T, C)."""
    cw = w.shape[0]
    xx = torch.cat([x.new_zeros((cw - 1, x.shape[1])), x])
    out = sum(xx[i:i + x.shape[0]] * w[i].float() for i in range(cw))
    if b is not None:
        out = out + b.float()
    return F.silu(out)


def ssd(x: Tensor, dt: Tensor, a: Tensor, B: Tensor, C: Tensor, chunk: int) -> Tensor:
    """The SSD recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T``,
    ``y_t = h_t C_t`` from h = 0, in chunks of ``chunk`` tokens: inside a
    chunk the masked quadratic form, across chunks the carried state.
    x (T, H, P), dt (T, H), a (H,) (negative), B / C (T, N). y (T, H, P)."""
    T, H, P = x.shape
    h = x.new_zeros((H, P, B.shape[1]))
    ys = []
    for lo in range(0, T, chunk):
        hi = min(T, lo + chunk)
        xc, dtc, Bc, Cc = x[lo:hi], dt[lo:hi], B[lo:hi], C[lo:hi]
        cum = torch.cumsum(dtc * a, dim=0)                              # (q, H)
        seg = cum[:, None, :] - cum[None, :, :]                         # (t, s, H)
        causal = torch.ones(hi - lo, hi - lo, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~causal[..., None], float("-inf")))
        w = (Cc @ Bc.t())[..., None] * decay * dtc[None, :, :]          # (t, s, H)
        y = torch.einsum("tsh,shp->thp", w, xc)
        y = y + torch.einsum("tn,hpn->thp", Cc, h) * torch.exp(cum)[..., None]
        ys.append(y)
        tail = torch.exp(cum[-1][None] - cum) * dtc                      # (s, H)
        h = h * torch.exp(cum[-1])[:, None, None] + torch.einsum("sh,shp,sn->hpn", tail,
                                                                   xc, Bc)
    return torch.cat(ys)


def _mamba(u: Tensor, mp: Dict[str, Tensor], m: Dict, eps: float, quant) -> Tensor:
    T = u.shape[0]
    z = _linear(u, mp["w_z"], quant)
    xs = _conv(_linear(u, mp["w_x"], quant), mp["conv_x"], mp.get("conv_bias_x"))
    B = _conv(_linear(u, mp["w_B"], quant), mp["conv_B"], mp.get("conv_bias_B"))
    C = _conv(_linear(u, mp["w_C"], quant), mp["conv_C"], mp.get("conv_bias_C"))
    dt = F.softplus(_linear(u, mp["w_dt"], quant) + mp["dt_bias"].float(), threshold=1e9)
    a = -torch.exp(mp["A_log"].float())
    xh = xs.reshape(T, m["mh"], m["P"])
    y = ssd(xh, dt, a, B, C, m["Q"]) + mp["D"].float()[:, None] * xh
    y = _rms(y.reshape(T, -1) * F.silu(z), mp["norm"], eps)
    return _linear(y, mp["w_out"], quant)


def _attention(u: Tensor, ap: Dict[str, Tensor], m: Dict, scale: float, quant) -> Tensor:
    """Causal GQA attention without position embedding, scores x ``scale``,
    by blocks of query rows."""
    T, d = u.shape
    q = _linear(u, ap["wq"].reshape(d, -1), quant).unflatten(-1, (m["H"], m["hd"]))
    k = _linear(u, ap["wk"].reshape(d, -1), quant).unflatten(-1, (m["KV"], m["hd"]))
    v = _linear(u, ap["wv"].reshape(d, -1), quant).unflatten(-1, (m["KV"], m["hd"]))
    g = m["H"] // m["KV"]
    kk = k.repeat_interleave(g, dim=1).transpose(0, 1)                  # (H, T, hd)
    vv = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for lo in range(0, T, Q_ROWS):
        hi = min(T, lo + Q_ROWS)
        sc = torch.einsum("qhd,htd->hqt", q[lo:hi], kk[:, :hi]) * scale
        mask = torch.arange(hi, device=u.device)[None, :] > \
            torch.arange(lo, hi, device=u.device)[:, None]
        sc.masked_fill_(mask[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqt,htd->qhd", torch.softmax(sc, dim=-1), vv[:, :hi])
    return _linear(out.flatten(-2), ap["wo"].reshape(-1, d), quant)


def _gated(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor, quant) -> Tensor:
    return _linear(F.silu(_linear(x, wg, quant)) * _linear(x, wu, quant), wd, quant)


def ffn(y: Tensor, lp: Dict[str, Tensor], k: int, quant=None, first: int = 0) -> Tensor:
    """The routed experts held in ``lp`` (experts ``first`` .. ``first`` +
    held - 1 of the router's) plus the shared expert. The router: softmax
    over its top-k logits; each token through its routed held experts."""
    top_v, top_i = torch.topk(_linear(y, lp["moe_router"], quant), k, dim=-1)
    top_p = torch.softmax(top_v, dim=-1)
    out = _gated(y, lp["shared_w_gate"], lp["shared_w_up"], lp["shared_w_down"], quant)
    for e in range(lp["moe_w_gate"].shape[0]):
        rows, slot = torch.nonzero(top_i == first + e, as_tuple=True)
        if rows.numel() == 0:
            continue
        h = _gated(y[rows], lp["moe_w_gate"][e], lp["moe_w_up"][e], lp["moe_w_down"][e],
                   quant)
        out.index_add_(0, rows, h * top_p[rows, slot, None])
    return out


@torch.no_grad()
def logits_at(params: Dict, cfg: Dict, tokens: Iterable[int], rows: Iterable[int],
              quant: Optional[str] = None) -> Tensor:
    """Logits (len(rows), V) fp32 of the sequence ``tokens`` at ``rows``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = dims(cfg)
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    dev = params["embed"].device
    tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    x = params["embed"][tok].float() * cfg["embedding_multiplier"]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"]):
        lp = {name: leaf[i] for name, leaf in params["layers"].items()}
        j = seen[kind]
        seen[kind] += 1
        u = _rms(x, lp["norm_mixer"], eps)
        if kind == "mamba":
            out = _mamba(u, {n: leaf[j] for n, leaf in params["mamba"].items()}, m, eps, quant)
        else:
            out = _attention(u, {n: leaf[j] for n, leaf in params["attn"].items()}, m,
                             cfg["attention_multiplier"], quant)
        x = x + out * rm
        x = x + ffn(_rms(x, lp["norm_ffn"], eps), lp, m["k"], quant) * rm
        del out, u
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
    xr = _rms(x[idx], params["final_norm"], eps)
    return _linear(xr, params["embed"].t(), quant) / cfg["logits_scaling"]
