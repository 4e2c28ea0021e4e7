"""The production meshes. Port of ``repro/launch/mesh.py``.

The reference builds ``jax.make_mesh`` over devices (512 forced host
devices in its dry-run). One GPU has no such mesh, so here a mesh is an
:class:`~repro_torch.distributed.sharding.AbstractMesh`: axis names and
sizes, no devices. It is all the dry-run needs, since the port derives
shard sizes and collective bytes from the spec tuples.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod.

    Single-pod axes: ("data", "model"). Multi-pod adds a leading "pod" axis:
    in training it is extra data parallelism across nodes; in FlowKV
    serving it is the P/D boundary (pod 0 = prefill cluster, pod 1 = decode
    cluster).
    """
    if multi_pod:
        return AbstractMesh(pod=2, data=16, model=16)
    return AbstractMesh(data=16, model=16)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0) -> AbstractMesh:
    """A mesh of the given sizes (the reference's CPU-scale test mesh)."""
    if pod:
        return AbstractMesh(pod=pod, data=data, model=model)
    return AbstractMesh(data=data, model=model)
