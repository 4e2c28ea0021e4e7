"""Cluster-wide prefix index (paper §3.2: the controller "identifies global
cache prefix matches to boost throughput and reduce KV Cache transfer
latency"), grown tier-aware in the Mooncake/KVCache-centric direction.

Prefixes are tracked at block granularity: a chain of rolling hashes, one per
full block of tokens, per node. Each entry also records **which tier** holds
that block's KV on the node and the *physical block id in that tier's
namespace*, which is what makes a hit actionable:

* ``"hbm"`` entries point at pool blocks — the scheduler shares those very
  blocks (ref-counted) into the new request's block table, or the runtime
  pulls them from a remote node's pool as one fused descriptor-table
  transfer (see ``serving/cluster.py``);
* ``"dram"`` entries point at host-tier blocks — cold prefixes demoted out
  of the pool by LRU pressure (``serving/host_tier.py``). They are promoted
  back to pool blocks (one fused host->HBM dispatch) before any reuse, so
  the data plane only ever shares HBM blocks.

Honesty rules (the three phantom-hit bugs this module used to have):

* **Stable hashing** — the chain uses ``blake2b`` over the rolling digest and
  the block's token ids, NOT Python's per-process-salted builtin ``hash()``,
  so index state means the same thing across processes and checkpoint
  restores (``PYTHONHASHSEED``-independent, tested).
* **Residency is block-backed** — an entry only advertises KV that a live
  block holds. ``invalidate_blocks`` is called from every pool-recycle path
  (``BlockManager.on_free``) and ``invalidate_host_blocks`` from every
  host-tier eviction; demotion re-points the entry (pool block -> host
  block) BEFORE the pool block frees, so the handoff never advertises dead
  KV in either tier.
* **Re-homing** — after a P->D transfer the KV lives on the decode node, so
  the runtime re-inserts the entry there with the destination block ids and
  the source-side entry dies with the source blocks.

Entries inserted without block ids (``block_ids=None``) still *match* — they
support routing-signal-only callers and tests — but ``lookup`` reports no
shareable blocks for them, so the data plane never pretends to reuse KV it
cannot address.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

TIER_HBM = "hbm"
TIER_DRAM = "dram"


def _block_hashes(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Rolling per-block digest chain: hash(i) covers tokens[0 : (i+1)*block).

    ``blake2b`` over (previous digest, token ids) — deterministic across
    processes and Python versions (no interpreter hash salt).
    """
    hashes: List[bytes] = []
    h = b"\x00" * 16
    n_full = len(tokens) - len(tokens) % block_size
    for i in range(0, n_full, block_size):
        m = hashlib.blake2b(h, digest_size=16)
        m.update(struct.pack(f"<{block_size}q", *tokens[i:i + block_size]))
        h = m.digest()
        hashes.append(h)
    return hashes


@dataclasses.dataclass
class PrefixMatch:
    """A node's longest resident prefix for a prompt.

    ``num_tokens`` counts every matched full block; ``block_ids[i]`` /
    ``tiers[i]`` hold the physical block (in its tier's namespace) and the
    tier name per matched block *when known* — shorter (or empty) lists than
    ``num_tokens/block_size`` mean the tail of the match came from entries
    without block backing and is NOT shareable.
    """

    num_tokens: int = 0
    block_ids: List[int] = dataclasses.field(default_factory=list)
    tiers: List[str] = dataclasses.field(default_factory=list)

    @property
    def dram_blocks(self) -> int:
        return sum(1 for t in self.tiers if t == TIER_DRAM)


class GlobalPrefixIndex:
    """chain digest -> (node, tier, block) over every node in the cluster."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        # node_id -> {chain digest -> (tier, block id) or None (unbacked)}
        self._node_hashes: Dict[int, Dict[bytes, Optional[Tuple[str, int]]]] = {}
        # node_id -> {pool block id -> chain digest} (HBM invalidation path)
        self._node_blocks: Dict[int, Dict[int, bytes]] = {}
        # node_id -> {host block id -> chain digest} (DRAM invalidation path)
        self._node_host_blocks: Dict[int, Dict[int, bytes]] = {}
        # node_id -> callback(host_block_ids): fired when a re-insert
        # re-points a digest AWAY from its DRAM backing (e.g. the prefix
        # re-homed to fresh pool blocks after a transfer) — the host tier
        # registers here so orphaned host blocks free instead of squatting
        # resident-but-unbacked forever.
        self.on_host_orphan: Dict[int, "object"] = {}

    @property
    def has_entries(self) -> bool:
        """True when ANY node advertises residency — routers check this
        before paying a full-prompt hashing pass that can only miss."""
        return any(self._node_hashes.values())

    def chain(self, tokens: Sequence[int]) -> List[bytes]:
        """The prompt's digest chain — compute ONCE per routing decision and
        pass to ``lookup``/``best_nodes``: routing probes every node, and
        re-hashing the whole prompt per probe is pure waste."""
        return _block_hashes(tokens, self.block_size)

    # -- updates ------------------------------------------------------------------
    def insert(self, node_id: int, tokens: Sequence[int],
               block_ids: Optional[Sequence[int]] = None,
               tier: str = TIER_HBM) -> None:
        """Record ``tokens``'s full-block prefix chain as resident on a node.

        ``block_ids[i]`` is the physical block (in ``tier``'s namespace)
        holding chain position ``i``; when given it must cover at least every
        full block of ``tokens``. Re-inserting an existing digest re-points
        it at the newest block (the copy most recently written, i.e. the one
        that lives longest).
        """
        hashes = _block_hashes(tokens, self.block_size)
        if block_ids is not None and len(block_ids) < len(hashes):
            raise ValueError(
                f"{len(hashes)} full blocks but only {len(block_ids)} block ids")
        by_hash = self._node_hashes.setdefault(node_id, {})
        for i, h in enumerate(hashes):
            if block_ids is None:
                # an unbacked insert must never disturb a backed entry's
                # block mapping (it would orphan the invalidation path)
                by_hash.setdefault(h, None)
                continue
            self._point(node_id, h, tier, int(block_ids[i]))

    def _point(self, node_id: int, digest: bytes, tier: str, block: int) -> None:
        """Re-point a digest's entry at (tier, block), unmapping the old one."""
        by_hash = self._node_hashes.setdefault(node_id, {})
        old = by_hash.get(digest)
        if old is not None and old != (tier, block):
            self._backmap(node_id, old[0]).pop(old[1], None)
            if old[0] == TIER_DRAM:
                cb = self.on_host_orphan.get(node_id)
                if cb is not None:
                    cb([old[1]])
        by_hash[digest] = (tier, block)
        self._backmap(node_id, tier)[block] = digest

    def _backmap(self, node_id: int, tier: str) -> Dict[int, bytes]:
        if tier == TIER_HBM:
            return self._node_blocks.setdefault(node_id, {})
        if tier == TIER_DRAM:
            return self._node_host_blocks.setdefault(node_id, {})
        raise ValueError(f"unknown tier {tier!r}")

    def demote_block(self, node_id: int, pool_block: int,
                     host_block: int) -> Optional[bytes]:
        """Pool block's KV moved to the host tier: re-point its entry.

        Runs BEFORE the pool block physically frees (``on_evict`` window),
        so the later ``on_free`` -> ``invalidate_blocks`` finds no mapping
        for the pool block and the dram entry survives. Returns the digest,
        or None when the pool block backed no entry (nothing to demote).
        """
        h = self._node_blocks.get(node_id, {}).pop(int(pool_block), None)
        if h is None:
            return None
        self._node_hashes[node_id][h] = (TIER_DRAM, int(host_block))
        self._backmap(node_id, TIER_DRAM)[int(host_block)] = h
        return h

    def promote_entry(self, node_id: int, host_block: int,
                      pool_block: int) -> Optional[bytes]:
        """Host block's KV copied back into a pool block: re-point its entry."""
        h = self._node_host_blocks.get(node_id, {}).pop(int(host_block), None)
        if h is None:
            return None
        self._node_hashes[node_id][h] = (TIER_HBM, int(pool_block))
        self._backmap(node_id, TIER_HBM)[int(pool_block)] = h
        return h

    def invalidate_blocks(self, node_id: int, block_ids: Iterable[int]) -> None:
        """Drop every entry whose backing POOL block was recycled.

        Wired as ``BlockManager.on_free`` so cache-evict / node teardown
        stop advertising dead HBM KV. Demoted entries are immune: demotion
        unmapped the pool block before it freed.
        """
        self._invalidate(node_id, block_ids, self._node_blocks)

    def invalidate_host_blocks(self, node_id: int,
                               block_ids: Iterable[int]) -> None:
        """Drop every entry whose backing HOST block was evicted/overwritten."""
        self._invalidate(node_id, block_ids, self._node_host_blocks)

    def _invalidate(self, node_id: int, block_ids: Iterable[int],
                    backmaps: Dict[int, Dict[int, bytes]]) -> None:
        by_hash = self._node_hashes.get(node_id)
        by_block = backmaps.get(node_id)
        if not by_block:
            return
        for b in block_ids:
            h = by_block.pop(int(b), None)
            if h is not None:
                by_hash.pop(h, None)

    def evict_node(self, node_id: int) -> None:
        self._node_hashes.pop(node_id, None)
        self._node_blocks.pop(node_id, None)
        self._node_host_blocks.pop(node_id, None)

    # -- queries ------------------------------------------------------------------
    def lookup(self, node_id: int, tokens: Sequence[int],
               hashes: Optional[List[bytes]] = None) -> PrefixMatch:
        """Longest resident prefix on ``node_id``, with its backing blocks.

        ``block_ids``/``tiers`` stop at the first unbacked entry: only a
        contiguous block-backed run is shareable by the data plane.
        ``hashes`` takes a precomputed :meth:`chain` (routing probes many
        nodes per request). Hit/miss rates are NOT counted here —
        speculative routing probes would swamp them; the runtimes count real
        hits at execution time.
        """
        resident = self._node_hashes.get(node_id)
        if not resident:
            return PrefixMatch()
        match = PrefixMatch()
        blocks_ok = True
        for h in (self.chain(tokens) if hashes is None else hashes):
            if h not in resident:
                break
            match.num_tokens += self.block_size
            entry = resident[h]
            if blocks_ok and entry is not None:
                match.block_ids.append(entry[1])
                match.tiers.append(entry[0])
            else:
                blocks_ok = False
        return match

    def match(self, node_id: int, tokens: Sequence[int]) -> int:
        """Longest cached prefix (in tokens) resident on ``node_id``."""
        return self.lookup(node_id, tokens).num_tokens

    def best_nodes(self, tokens: Sequence[int],
                   hashes: Optional[List[bytes]] = None) -> List[Tuple[int, int]]:
        """(node_id, matched_tokens) sorted by match length, desc."""
        hashes = self.chain(tokens) if hashes is None else hashes
        out = [(nid, self.lookup(nid, tokens, hashes).num_tokens)
               for nid in self._node_hashes]
        out.sort(key=lambda t: -t[1])
        return out

    def backed_block(self, node_id: int, block_id: int,
                     tier: str = TIER_HBM) -> bool:
        """True when this (tier, block) physically backs an index entry —
        the demotion filter: an unbacked pool block holds no advertised
        prefix, so evicting it loses nothing worth a DRAM copy."""
        maps = (self._node_blocks if tier == TIER_HBM
                else self._node_host_blocks)
        return int(block_id) in maps.get(node_id, {})

    def entry_tier(self, node_id: int, digest: bytes) -> Optional[str]:
        """The tier backing one digest on a node (None = absent/unbacked)."""
        entry = self._node_hashes.get(node_id, {}).get(digest)
        return None if entry is None else entry[0]

    def stats(self) -> Dict[str, int]:
        return {
            "nodes": len(self._node_hashes),
            "total_entries": sum(len(s) for s in self._node_hashes.values()),
            "backed_entries": sum(len(s) for s in self._node_blocks.values())
            + sum(len(s) for s in self._node_host_blocks.values()),
            "dram_entries": sum(len(s)
                                for s in self._node_host_blocks.values()),
        }


# PR 5 name: same object, pre-tier API is a strict subset.
PrefixCacheIndex = GlobalPrefixIndex
