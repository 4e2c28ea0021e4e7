"""The port's copied control plane against the reference: the same op
sequences (those of test_allocator.py, test_alignment.py and
test_block_invariants.py) through both packages' allocators, BlockManager
and align() must leave identical states after every op."""
import random

import pytest

pytest.importorskip("torch")

from repro.core import alignment as RAL  # noqa: E402
from repro.core import allocator as RAC  # noqa: E402
from repro.core import block_manager as RBM  # noqa: E402
from repro.core import costmodel as RCM  # noqa: E402
from repro.core import segments as RSG  # noqa: E402
from repro.serving import prefix_cache as RPC  # noqa: E402
from repro_torch.core import alignment as AL  # noqa: E402
from repro_torch.core import allocator as AC  # noqa: E402
from repro_torch.core import block_manager as BM  # noqa: E402
from repro_torch.core import costmodel as CM  # noqa: E402
from repro_torch.core import segments as SG  # noqa: E402
from repro_torch.serving import prefix_cache as PC  # noqa: E402


def _runs(res):
    return [(r.src.start, r.src.length, r.dst.start, r.dst.length) for r in res.runs]


def test_align_matches_reference():
    rng = random.Random(0)
    cases = [([0, 1, 2, 5, 6], [3, 4, 5, 6, 7]), (list(range(10)), list(range(9, -1, -1))),
             ([], []), (list(range(7)), list(range(3, 10)))]
    for _ in range(60):
        n = rng.randint(0, 120)
        cases.append((rng.sample(range(200), n), rng.sample(range(200), n)))
    for src, dst in cases:
        a, b = AL.align(src, dst), RAL.align(src, dst)
        assert _runs(a) == _runs(b)
        assert (a.num_calls, a.num_blocks, a.merge_ratio) == \
            (b.num_calls, b.num_blocks, b.merge_ratio)
        assert AL.reconstruct(a) == RAL.reconstruct(b) == (src, dst)
    with pytest.raises(ValueError):
        AL.align([1], [1, 2])


def test_segments_match_reference():
    rng = random.Random(1)
    for _ in range(40):
        ids = [rng.randint(0, 500) for _ in range(rng.randint(0, 200))]
        a, b = SG.blocks_to_segments(ids), RSG.blocks_to_segments(ids)
        assert [(s.start, s.length) for s in a] == [(s.start, s.length) for s in b]
        assert SG.fragmentation(a) == RSG.fragmentation(b)


@pytest.mark.parametrize("cls", ["BlockAllocator", "SegmentAllocator"])
def test_allocator_traces_match_reference(cls):
    """The alloc/free/extend traces of test_allocator.py, op by op."""
    rng = random.Random(2)
    for seed in range(12):
        ops = [(rng.choice(["alloc", "free", "extend"]), rng.randint(1, 40))
               for _ in range(rng.randint(1, 120))]
        mine, ref = getattr(AC, cls)(256), getattr(RAC, cls)(256)
        pick = random.Random(seed)
        live_m, live_r = {}, {}
        for i, (kind, n) in enumerate(ops):
            if kind == "alloc":
                if n <= ref.num_free:
                    live_r[i], live_m[i] = ref.allocate(n), mine.allocate(n)
                else:
                    with pytest.raises(AC.OutOfBlocksError):
                        mine.allocate(n)
            elif kind == "free" and live_r:
                victim = pick.choice(sorted(live_r))
                ref.free(live_r.pop(victim))
                mine.free(live_m.pop(victim))
            elif kind == "extend" and live_r and ref.num_free >= 1:
                victim = pick.choice(sorted(live_r))
                live_r[victim] = live_r[victim] + ref.extend(live_r[victim], 1)
                live_m[victim] = live_m[victim] + mine.extend(live_m[victim], 1)
            mine.check_invariants()
            assert live_m == live_r and mine.num_free == ref.num_free
            if cls == "SegmentAllocator":
                assert [(s.start, s.length) for s in mine.free_segments()] == \
                    [(s.start, s.length) for s in ref.free_segments()]


OPS = ("alloc", "share", "free", "grow", "reclaim", "release_all", "register")


def _bm_step(bm, index, live, rng, op, state):
    """One op of test_block_invariants.py's vocabulary (no host tier)."""
    bs = bm.block_size
    if op == "alloc":
        ntok = rng.randint(1, 6) * bs
        if bm.can_allocate(ntok):
            rid = state["rid"] = state["rid"] + 1
            prompt = list(range(state["tok"], state["tok"] + ntok))
            state["tok"] += ntok
            bm.allocate(rid, ntok)
            index.insert(0, prompt, bm.get(rid))
            live[rid] = prompt
    elif op == "share" and live:
        donor = live[rng.choice(sorted(live))]
        m = index.lookup(0, donor)
        lead = [b for b in m.block_ids if bm.block_alive(b)][:len(m.block_ids)]
        if lead:
            k = rng.randint(1, len(lead))
            ntok = k * bs + rng.randint(0, 2) * bs
            if bm.can_allocate(ntok, shared_blocks=k, shared_block_ids=lead[:k]):
                rid = state["rid"] = state["rid"] + 1
                bm.allocate(rid, ntok, prefix_blocks=lead[:k])
                live[rid] = donor[:k * bs]
    elif op == "free" and live:
        rid = rng.choice(sorted(live))
        bm.free(rid)
        del live[rid]
    elif op == "grow" and live:
        rid = rng.choice(sorted(live))
        if bm.free_capacity >= 1:
            bm.ensure_capacity(rid, (len(bm.get(rid)) + 1) * bs)
    elif op == "reclaim":
        bm.reclaim_cache(rng.randint(1, 8))
    elif op == "release_all":
        bm.release_all()
        live.clear()
    elif op == "register":
        ntok = rng.randint(1, 3) * bs
        if bm.can_allocate(ntok):
            rid = state["rid"] = state["rid"] + 1
            bm.register(rid, ntok)
            live[rid] = []


def _bm_state(bm):
    return (dict(bm._table), dict(bm._refcount), list(bm._cached), bm.num_free,
            bm.free_capacity, bm.utilization)


@pytest.mark.parametrize("allocator", ["flowkv", "vllm", "freelist"])
def test_block_manager_traces_match_reference(allocator):
    rng_ops = random.Random(7)
    for trial in range(60):
        ops = [rng_ops.choice(OPS) for _ in range(rng_ops.randint(1, 60))]
        planes = []
        for bm_mod, pc_mod in ((BM, PC), (RBM, RPC)):
            bm = bm_mod.BlockManager(32, 4, allocator)
            index = pc_mod.GlobalPrefixIndex(4)
            bm.on_free = lambda blocks, ix=index: ix.invalidate_blocks(0, blocks)
            planes.append((bm, index, {}, random.Random(trial), {"rid": 0, "tok": 1}))
        for op in ops:
            for bm, index, live, rng, state in planes:
                _bm_step(bm, index, live, rng, op, state)
                bm.check_invariants()
                bm.assert_no_leaks(list(live))
            assert _bm_state(planes[0][0]) == _bm_state(planes[1][0]), op


def test_costmodel_and_routes_match_reference():
    for same_host in (True, False):
        for target in ("gpu", "tpu"):
            a, b = CM.select_route(same_host, target), RCM.select_route(same_host, target)
            assert a.name == b.name
            for calls, nbytes in ((1, 117 << 20), (23469, 1 << 30)):
                assert a.latency(calls, nbytes) == b.latency(calls, nbytes)


def test_h100_profile_from_the_data_sheet():
    from repro_torch.sim.hardware import H100, get_hardware
    assert get_hardware("h100") is H100
    assert (H100.peak_flops, H100.hbm_bandwidth, H100.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert H100.intra_host is CM.IPC and H100.inter_host is CM.NCCL_ENI
