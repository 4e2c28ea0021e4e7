"""Roofline terms, collective bytes and memory of a dry-run cell, priced for
the H100. Counterpart of the reference's ``repro/launch/hlo_analysis.py``.

The reference parses collectives out of the compiled HLO text and prices
every term with TPU v5e constants. One GPU has no HLO and no 512-device
mesh, so here:

* FLOPs and bytes come from ``launch/op_counts.py`` (every aten op of the
  step, traced on ``meta``), per chip;
* collective bytes are derived from the spec tuples (:func:`collective_bytes`);
* every term is priced with the H100 SXM5 data sheet's figures below. They
  are data-sheet figures, not measurements:

      compute    = FLOPs / 989e12            (dense bf16, sim/hardware.py::H100)
      memory     = bytes / 3.35e12           (HBM3, sim/hardware.py::H100)
      collective = NVLink bytes / 450e9      (NVLink 4, per direction)
                 + network bytes / 50e9      (400 Gb/s NDR InfiniBand per GPU)

A collective whose group fits in one 8-GPU NVLink domain is priced at the
NVLink rate, any wider group at the network rate, as the reference prices
an intra-pod group at ICI and a pod-crossing one at DCN (``crosses_pod``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.distributed import sharding as SH
from repro_torch.sim.hardware import H100

PEAK_FLOPS = H100.peak_flops         # 989e12 bf16 FLOP/s per GPU (data sheet)
HBM_BW = H100.hbm_bandwidth          # 3.35e12 bytes/s per GPU (data sheet)
NVLINK_BW = 450e9                    # bytes/s per GPU, each direction (data sheet)
NET_BW = 50e9                        # bytes/s per GPU across nodes: 400 Gb/s NDR
NVLINK_GROUP = 8                     # GPUs of one NVLink domain (an HGX H100 node)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-chip counted FLOPs
    hbm_bytes: float             # per-chip bytes accessed
    coll_bytes: float            # per-chip collective bytes
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_from(cost: Dict, coll: Dict[str, int], model_flops: Optional[float] = None,
                  link_bw: float = NVLINK_BW) -> Roofline:
    """The reference's ``roofline_from``: ``cost`` holds per-chip "flops"
    and "bytes accessed", ``coll`` per-chip collective bytes ("total"),
    priced at ``link_bw``. :func:`price` re-prices the collective term by
    fabric."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    hbm = float(cost.get("bytes accessed", 0.0) or 0.0)
    cb = float(coll.get("total", 0))
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    collective_s = cb / link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = None
    if model_flops:
        useful = model_flops / flops if flops else None
    return Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=cb,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s, bottleneck=bottleneck,
                    model_flops=model_flops, useful_ratio=useful)


def price(cost: Dict, coll: Dict[str, int], model_flops: Optional[float] = None) -> Roofline:
    """:func:`roofline_from` with the collective term priced by fabric:
    the NVLink share at ``NVLINK_BW``, the network share at ``NET_BW``."""
    roof = roofline_from(cost, coll, model_flops=model_flops)
    roof.collective_s = coll["nvlink_total"] / NVLINK_BW + coll["net_total"] / NET_BW
    terms = {"compute": roof.compute_s, "memory": roof.memory_s,
             "collective": roof.collective_s}
    roof.bottleneck = max(terms, key=terms.get)
    return roof


def _group(mesh: SH.AbstractMesh, axes) -> int:
    sizes = SH.mesh_axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in axes)


def activation_specs(cfg, kind: str, seq: int, batch: int, mesh: SH.AbstractMesh
                     ) -> List[Tuple[Any, Tuple, int]]:
    """The residual stream that a tensor-parallel layer all-reduces, as
    (meta tensor (batch, tokens, d_model), its spec, layers) for each stack:
    ``seq`` tokens a sequence in train and prefill, one in decode. An enc-dec
    model has two stacks: the encoder over ``seq`` frames (train, prefill),
    the decoder over ``max(seq // 8, 128)`` tokens (train), 1 (prefill,
    decode)."""
    import torch

    def act(tokens: int, layers: int):
        t = torch.empty((batch, tokens, cfg.d_model), dtype=cfg.dtype, device="meta")
        return t, SH.spec_for(t.shape, ("batch", "seq", "embed"), mesh), layers

    if cfg.family == "encdec":
        stacks = [act(1 if kind != "train" else max(seq // 8, 128), cfg.num_layers)]
        if kind != "decode":
            stacks.append(act(seq, cfg.num_encoder_layers))
        return stacks
    return [act(1 if kind == "decode" else seq, cfg.num_layers)]


def collective_bytes(kind: str, cfg, specs: Dict[str, Any], mesh: SH.AbstractMesh
                     ) -> Dict[str, int]:
    """Per-device collective bytes of one step by kind, derived from the
    spec tuples (one card has no collectives to parse). Bytes are result
    buffers, as the reference counts them (``hlo_analysis.collective_bytes``).

    ``specs``: "activations", the list of :func:`activation_specs`; for
    train also "params" (compute params, TP spec) and "master" (the fp32
    masters, ZeRO-1 spec ``zero1_specs``), each a (shapes, specs) pair.

    * all-reduce over "model" (size > 1): the residual stream of each layer,
      A = bytes_per_device(activation), 2 a layer forward (after the
      attention output projection and after the MLP's down projection;
      1 for an ssm layer, which has no MLP), 2 more a layer backward in
      train.
    * all-to-all over "model": where a MoE's experts shard over it
      (num_experts % model == 0), the dispatch and the combine of each
      layer, A * top_k each, forward (x2 in train).
    * ZeRO-1 in train, where the data(+pod) group is > 1: reduce-scatter of
      the fp32 gradients into the optimizer shards (their result:
      bytes_per_device(master, zero1 spec)) and all-gather of the updated
      compute params (bytes_per_device(params, TP spec)), once a step.

    "nvlink_total" / "net_total" split the total by fabric: a group of at
    most ``NVLINK_GROUP`` GPUs rides NVLink, a wider one the network.
    """
    out = {k: 0 for k in COLLECTIVE_OPS}
    nvlink = net = 0
    model = _group(mesh, ("model",))
    dp = _group(mesh, ("pod", "data"))
    passes = 2 if kind == "train" else 1

    def add(op: str, nbytes: int, group: int) -> None:
        nonlocal nvlink, net
        out[op] += nbytes
        if group <= NVLINK_GROUP:
            nvlink += nbytes
        else:
            net += nbytes

    if model > 1:
        per_layer = 1 if cfg.family == "ssm" else 2
        for act, spec, layers in specs["activations"]:
            a = SH.bytes_per_device(act, spec, mesh)
            add("all-reduce", passes * per_layer * layers * a, model)
            if cfg.family == "moe" and cfg.num_experts % model == 0:
                add("all-to-all", passes * 2 * layers * a * cfg.top_k, model)
    if kind == "train" and dp > 1:
        add("reduce-scatter", SH.bytes_per_device(*specs["master"], mesh), dp)
        add("all-gather", SH.bytes_per_device(*specs["params"], mesh), dp)
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    out["nvlink_total"] = nvlink
    out["net_total"] = net
    return out


def memory_analysis_dict(resident: int, output_bytes: int, alias_bytes: int,
                         peak_bytes: int, chips: int) -> Dict[str, Any]:
    """The reference's ``memory_analysis`` fields, per device:

    * ``argument_size_in_bytes``: the resident state (params, cache or train
      state), exact: ``bytes_per_device`` over its spec tuples;
    * ``output_size_in_bytes``: the trace's output bytes that are new
      storage; ``alias_size_in_bytes``: its outputs that are inputs updated
      in place (the decode cache);
    * ``temp_size_in_bytes``: the peak of the trace's live set
      (``OpCounts.peak_bytes``).

    The last three come from a trace at the global batch and are divided by
    the chip count: ESTIMATED, assuming the step's temporaries shard evenly.
    """
    return {"argument_size_in_bytes": float(resident),
            "output_size_in_bytes": output_bytes / chips,
            "alias_size_in_bytes": alias_bytes / chips,
            "temp_size_in_bytes": peak_bytes / chips,
            "estimated": ["output_size_in_bytes", "alias_size_in_bytes",
                          "temp_size_in_bytes"]}
