"""Logical-axis -> mesh-axis rules with divisibility fallbacks. A
framework-free copy of the part of ``repro/distributed/sharding.py`` that
``tp.py`` and ``steps.py`` need: the rule table, an abstract mesh,
``spec_for`` and ``tree_specs``.

Models annotate every parameter dim with a *logical* axis name
(``transformer.param_axes``); ``spec_for`` walks a tensor's dims in order
and assigns each its first candidate mesh axis that is unused in the tensor
and divides the dim. The result is a tuple — the reference's
``PartitionSpec`` entries, trailing ``None`` trimmed — so the port's shard
slicing follows the reference's rule walk exactly, without
``jax.sharding``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

# logical axis -> ordered mesh-axis candidates. Each candidate is a tuple of
# mesh axes to use JOINTLY for that dim (e.g. batch over pod x data).
DEFAULT_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "batch": (("pod", "data"), ("data",)),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "mlp": (("model",),),
    "experts": (("model",),),
    "vocab": (("model",),),
    "inner": (("model",),),     # mamba2 d_inner channels
    "lru": (("model",),),       # griffin RG-LRU width
    "kv_seq": (("model",),),    # decode-cache length dim (fallback TP target)
    # A paged pool's page dim is pinned to replication: page ids are global
    # names shared by every shard's block manager and transfer descriptor
    # table. A paged pool shards only inside the payload (its kv-head slice;
    # serving/kv_cache.ShardedKVCache), never across pages.
    "kv_pages": (),
    # replicated: embed, head_dim, seq, layers, groups, conv, state, lru_in
}

# Canonical logical axes of a FLOWKV paged pool (num_blocks, L, 2, payload).
PAGED_POOL_AXES: Tuple[Optional[str], ...] = ("kv_pages", "layers", None, None)


class AbstractMesh:
    """A mesh as ``spec_for`` sees it: axis names and their sizes, no devices.

    The single-device TP emulation (``distributed/tp.py``) plans its
    parameter slices for a ``model`` axis of size ``tp`` with it.
    """

    def __init__(self, **sizes: int):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def mesh_axis_sizes(mesh: AbstractMesh) -> Dict[str, int]:
    return dict(mesh.shape)


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh: AbstractMesh, rules: Optional[Dict] = None
             ) -> Tuple[object, ...]:
    """One tensor's mesh-axis assignment per dim (None = replicated), with
    divisibility fallbacks; trailing Nones trimmed."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    parts = []
    assert len(shape) == len(logical), (shape, logical)
    for dim, name in zip(shape, logical):
        assigned = None
        for cand in rules.get(name or "", ()):
            cand = tuple(ax for ax in cand if ax in sizes)
            if not cand or any(ax in used for ax in cand):
                continue
            total = math.prod(sizes[ax] for ax in cand)
            if dim % total != 0:
                continue
            assigned = cand
            used.update(cand)
            break
        if assigned is None:
            parts.append(None)
        elif len(assigned) == 1:
            parts.append(assigned[0])
        else:
            parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def tree_specs(shapes_tree, axes_tree, mesh: AbstractMesh,
               rules: Optional[Dict] = None):
    """``spec_for`` over parallel nested dicts: shapes (anything with a
    ``.shape``: tensors, meta tensors) and logical axes."""
    if isinstance(shapes_tree, dict):
        return {k: tree_specs(v, axes_tree[k], mesh, rules) for k, v in shapes_tree.items()}
    return spec_for(tuple(shapes_tree.shape), axes_tree, mesh, rules)
