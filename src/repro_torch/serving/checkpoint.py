"""Checkpoint/restore for the serving cluster and the training state. Port
of ``repro/serving/checkpoint.py``.

Serving: captures every node's pool, block tables, queue contents and
in-flight request lifecycle so a controller restart resumes mid-stream.
Training: params / optimizer state / step in one ``step_XXXXXXXX.npz``
written atomically (crash-safe), plus ``latest_checkpoint`` for
resume-from-latest. Keys are the leaves' paths joined by "/"
(``params/layers/wq``, ``step``); a bf16 leaf is saved as fp32 under
``key + "@bf16"`` and comes back bit for bit.

Format: numpy ``.npz`` for arrays + msgpack for structure, the reference's
own files: a checkpoint either package writes, the other loads. Pools and
spilled K/V are saved as float32 (exact for bf16) and restored onto the
pool's own device and dtype, in place — the port's pools keep their
storage. The host-DRAM tier is not saved (the reference saves none): a
restore starts it empty.
"""
from __future__ import annotations

import os
import pathlib
import tempfile
from typing import Dict, Optional

import msgpack
import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serving.request import Request, RequestState, SamplingParams


# ---------------------------------------------------------------------------
# Request (de)serialization
# ---------------------------------------------------------------------------
def request_to_dict(r: Request) -> dict:
    return {
        "request_id": int(r.request_id),
        "prompt_tokens": [int(t) for t in r.prompt_tokens],
        "output_tokens": [int(t) for t in r.output_tokens],
        "state": r.state.value,
        "prefill_node": r.prefill_node,
        "decode_node": r.decode_node,
        "block_ids": [int(b) for b in r.block_ids],
        "arrival_time": r.arrival_time,
        "max_new_tokens": r.sampling.max_new_tokens,
        "retries": r.retries,
        "retry_after": r.retry_after,
        "reject_reason": r.reject_reason,
        "num_cached_prefix_tokens": int(r.num_cached_prefix_tokens),
        "prefix_src_node": r.prefix_src_node,
        "prefix_block_ids": [int(b) for b in r.prefix_block_ids],
    }


def request_from_dict(d: dict) -> Request:
    r = Request(prompt_tokens=list(d["prompt_tokens"]),
                sampling=SamplingParams(max_new_tokens=d["max_new_tokens"]),
                request_id=d["request_id"], arrival_time=d["arrival_time"])
    r.output_tokens = list(d["output_tokens"])
    r.state = RequestState(d["state"])
    r.prefill_node = d["prefill_node"]
    r.decode_node = d["decode_node"]
    r.block_ids = list(d["block_ids"])
    r.retries = d["retries"]
    r.retry_after = d.get("retry_after")
    r.reject_reason = d.get("reject_reason")
    r.num_cached_prefix_tokens = int(d.get("num_cached_prefix_tokens", 0))
    r.prefix_src_node = d.get("prefix_src_node")
    r.prefix_block_ids = list(d.get("prefix_block_ids", []))
    return r


# ---------------------------------------------------------------------------
# Serving cluster checkpoint
# ---------------------------------------------------------------------------
def cluster_state(cluster) -> dict:
    nodes = {}
    for nid, engine in cluster.engines.items():
        if engine.slots is not None:
            raise ValueError(f"{engine.cfg.family!r} holds state slots, which a "
                             "checkpoint does not save")
        sched = engine.scheduler
        node = {
            "role": cluster.controller.nodes[nid].role,
            "alive": cluster.controller.nodes[nid].alive,
            # role-lifecycle state (set_role / role_flip policy)
            "home_role": cluster.controller.nodes[nid].home_role,
            "priority": sched.priority,
            "priority_cycles_left": sched._priority_cycles_left,
            "queues": {
                "prefill_waiting": [request_to_dict(r) for r in sched.prefill.waiting],
                "prefill_running": [request_to_dict(r) for r in sched.prefill.running],
                "sending": [request_to_dict(r) for r in sched.prefill.sending],
                "decode_running": [request_to_dict(r) for r in sched.decode.running],
                "decode_swapped": [request_to_dict(r) for r in sched.decode.swapped],
            },
            "block_table": {str(rid): [int(b) for b in engine.scheduler.bm.get(rid)]
                            for rid in list(engine.scheduler.bm._table)},
            # spill-path bookkeeping: lengths here, arrays in pools.npz —
            # a checkpoint taken mid-swap must not lose the saved KV
            "spilled": {str(rid): int(length)
                        for rid, (_, _, length) in engine.spilled.items()},
        }
        nodes[str(nid)] = node
    return {"clock": cluster.clock, "nodes": nodes,
            "finished": [request_to_dict(r) for r in cluster.finished],
            "cancelled": [request_to_dict(r) for r in getattr(cluster, "cancelled", [])],
            "rejected": [request_to_dict(r) for r in getattr(cluster, "rejected", [])]}


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def save_cluster(cluster, path: str) -> None:
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = cluster_state(cluster)
    _atomic_write_bytes(path / "meta.msgpack", msgpack.packb(meta))
    arrays = {}
    for nid, engine in cluster.engines.items():
        if engine.paged:
            arrays[f"pool_{nid}"] = _f32(engine.kv.pool)
        # spilled K/V are the engine's CPU copies (NodeEngine._spill_kv)
        for rid, (k, v, _) in engine.spilled.items():
            arrays[f"spill_k_{nid}_{rid}"] = _f32(k)
            arrays[f"spill_v_{nid}_{rid}"] = _f32(v)
    _atomic_savez(path / "pools.npz", arrays)


def load_cluster(cluster, path: str) -> dict:
    """Restore pools + queues into an already-constructed cluster."""
    path = pathlib.Path(path)
    meta = msgpack.unpackb((path / "meta.msgpack").read_bytes(), strict_map_key=False)
    pools = np.load(path / "pools.npz")
    cluster.clock = meta["clock"]
    for nid_s, node in meta["nodes"].items():
        nid = int(nid_s)
        engine = cluster.engines[nid]
        # roles are runtime state since set_role / the role-flip policy:
        # restore them (plus scheduler priority) so routing and flip-back
        # resume where the checkpoint left off
        handle = cluster.controller.nodes[nid]
        handle.role = node.get("role", handle.role)
        handle.alive = bool(node.get("alive", handle.alive))
        handle.home_role = node.get("home_role")
        if node.get("priority"):
            # re-arm the lease countdown too, else a temporary priority
            # (imbalanced-regime lease) would become sticky across restore
            engine.scheduler.set_priority(node["priority"],
                                          cycles=node.get("priority_cycles_left", 0))
        if engine.paged and f"pool_{nid}" in pools:
            engine.kv.pool.copy_(torch.from_numpy(pools[f"pool_{nid}"]))
        dtype = engine.cfg.dtype        # the pool's dtype (spilled K/V: paged only)
        engine.spilled = {
            int(rid_s): (torch.from_numpy(pools[f"spill_k_{nid}_{rid_s}"]).to(dtype),
                         torch.from_numpy(pools[f"spill_v_{nid}_{rid_s}"]).to(dtype),
                         length)
            for rid_s, length in node.get("spilled", {}).items()}
        sched = engine.scheduler
        sched.prefill.waiting.clear(); sched.prefill.running.clear()
        sched.prefill.sending.clear(); sched.prefill.swapped.clear()
        sched.decode.running.clear(); sched.decode.swapped.clear()
        bm = sched.bm
        # the checkpoint is authoritative: release every live allocation
        # THROUGH the allocator first (a used cluster's post-save tables
        # would otherwise strand blocks as allocated-forever, or alias
        # since-freed blocks between a restored table and a new request),
        # then rebuild table + refcounts from the snapshot (a block in k
        # tables is a prefix shared k ways, matching check_invariants)
        bm.release_all()
        # the snapshot carries no prefix-index state: residency recorded
        # for this node — before OR since the save — now names blocks whose
        # contents the restore just rewrote. Evict rather than advertise
        # another request's KV; entries repopulate as restored traffic
        # finishes prefill.
        if getattr(cluster, "controller", None) is not None:
            cluster.controller.prefix_index.evict_node(nid)
        for rid_s, blocks in node["block_table"].items():
            bm._table[int(rid_s)] = list(blocks)
            for b in blocks:
                bm._refcount[b] = bm._refcount.get(b, 0) + 1
                if isinstance(bm.allocator.__dict__.get("_free"), list):
                    try:
                        bm.allocator._free.remove(b)
                        bm.allocator._allocated.add(b)
                    except ValueError:
                        pass
        if hasattr(bm.allocator, "free_segments"):
            _rebuild_segment_allocator(bm)
        for qname, target in (("prefill_waiting", sched.prefill.waiting),
                              ("prefill_running", sched.prefill.running),
                              ("sending", sched.prefill.sending),
                              ("decode_running", sched.decode.running),
                              ("decode_swapped", sched.decode.swapped)):
            for rd in node["queues"][qname]:
                target.append(request_from_dict(rd))
    cluster.finished = [request_from_dict(d) for d in meta["finished"]]
    cluster.cancelled = [request_from_dict(d) for d in meta.get("cancelled", [])]
    cluster.rejected = [request_from_dict(d) for d in meta.get("rejected", [])]
    return meta


def _rebuild_segment_allocator(bm) -> None:
    """Reconstruct a SegmentAllocator's free heaps from the block table."""
    from repro_torch.core.allocator import SegmentAllocator
    from repro_torch.core.segments import Segment
    if not isinstance(bm.allocator, SegmentAllocator):
        return
    allocated = set()
    for blocks in bm._table.values():
        allocated.update(blocks)
    fresh = SegmentAllocator(bm.num_blocks)
    if allocated:
        # carve out the allocated ids
        fresh._allocated = set()
        fresh._heaps.__init__()
        fresh._by_start.clear(); fresh._by_end.clear()
        free_runs = []
        cur = None
        for b in range(bm.num_blocks):
            if b in allocated:
                if cur is not None:
                    free_runs.append((cur, b - cur))
                    cur = None
            else:
                if cur is None:
                    cur = b
        if cur is not None:
            free_runs.append((cur, bm.num_blocks - cur))
        for start, length in free_runs:
            fresh._insert_free(Segment(start, length))
        fresh._num_free = sum(l for _, l in free_runs)
        fresh._allocated = set(allocated)
    bm.allocator = fresh


# ---------------------------------------------------------------------------
# Training checkpoint (atomic, resume-from-latest)
# ---------------------------------------------------------------------------
def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of tensors -> {"a/b/c": array}, bf16 leaves as fp32
    under ``key + "@bf16"`` (numpy has no bfloat16)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = prefix + str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif v.dtype == torch.bfloat16:
            out[key + "@bf16"] = _f32(v)
        else:
            out[key] = v.detach().cpu().numpy()
    return out


def _unflatten_into(template, flat, prefix: str = "", device=None):
    """Tensors of ``template``'s structure, each leaf on the template leaf's
    device and in its dtype; a meta leaf goes to ``device``. ``flat`` maps
    keys to arrays (an open ``np.load`` file reads one leaf at a time)."""
    out = {}
    for k, t in template.items():
        key = prefix + str(k)
        if isinstance(t, dict):
            out[k] = _unflatten_into(t, flat, key + "/", device)
            continue
        arr = flat[key + "@bf16"] if key + "@bf16" in flat else flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                             f"the template {tuple(t.shape)}")
        dev = resolve_device(device) if t.device.type == "meta" else t.device
        out[k] = torch.from_numpy(arr).to(device=dev, dtype=t.dtype)
    return out


def save_train_state(state, step: int, ckpt_dir: str) -> str:
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:08d}.npz"
    _atomic_savez(final, _flatten(state))
    return str(final)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    ckpts = sorted(d.glob("step_*.npz"))
    return str(ckpts[-1]) if ckpts else None


def load_train_state(template, path: str, device=None):
    """The train state saved at ``path``, in ``template``'s structure,
    dtypes and devices. ``template`` may hold meta tensors
    (``distributed/steps.abstract_train_state``): those leaves go to
    ``device`` (default CUDA, as every entry point of the port)."""
    with np.load(path) as npz:
        return _unflatten_into(template, npz, device=device)


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------
def _atomic_write_bytes(path: pathlib.Path, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=str(path.parent))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_savez(path: pathlib.Path, arrays: Dict[str, np.ndarray]) -> None:
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
