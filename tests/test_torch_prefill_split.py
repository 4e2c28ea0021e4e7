"""The split arithmetic and the launch plan of the port's fp32 K4 kernel, on
the CPU.

``ref.flash_prefill_split_ref`` computes what the fp32 CUDA kernel
computes: one fp32 partial per run of ``keys_per_split`` keys counted from
key 0, combined in run order. It is held here against the reference's
Pallas kernel (interpret mode) on the same numpy inputs, within atol = rtol
= 2e-5 (the reference's own fp32 K4 tolerance: the two sum in different
orders), at lengths on and around the split boundaries, cold and in suffix
mode; and a row's result is held bit-identical whatever S and q_offset of
the call that computes it. ``ops.launch_plan`` is pinned on the chip
shapes and on e2e_prefix's shapes. The CUDA kernel itself is held against
the plain version on the card (``gpu`` tests in
``test_torch_prefill_kernels.py``).
"""
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_prefill import ops  # noqa: E402
from repro_torch.kernels.flash_prefill.ops import KEYS_PER_SPLIT, launch_plan  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import (  # noqa: E402
    flash_prefill_ref, flash_prefill_split_ref)

TOL = 2e-5
H, KV, HD = 4, 2, 16
H100_SMS = 132
# (keys per split, T): T at k * split - 1, k * split and k * split + 1
BOUNDARY = [(16, 15), (16, 16), (16, 17), (16, 33), (16, 48), (64, 63), (64, 64), (64, 65),
            (64, 129), (KEYS_PER_SPLIT, 511), (KEYS_PER_SPLIT, 512), (KEYS_PER_SPLIT, 513),
            (KEYS_PER_SPLIT, 1025)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under pytest-xdist (``-n 6``), and
    torch's default thread count oversubscribes the cores (a row loop of
    small einsums pays for that on every call)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from repro.kernels import flash_prefill
    return jnp, flash_prefill


def _inputs(rng, b, s, t, h=H, kv=KV, hd=HD):
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


@pytest.mark.parametrize("span,t", BOUNDARY)
def test_split_ref_matches_reference_kernel(ref, span, t):
    """Cold (S = T) and suffix (the last third of the rows) against the
    Pallas kernel over its padded tiles, and against the plain version."""
    jnp, rf = ref
    rng = np.random.RandomState(span + t)
    q, k, v = _inputs(rng, 2, t, t)
    for off in (0, 2 * t // 3):
        qs = q[:, off:]
        want = rf.flash_prefill_op(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v),
                                   q_blk=128, k_blk=128, q_offset=off)
        got = flash_prefill_split_ref(torch.from_numpy(qs), torch.from_numpy(k),
                                      torch.from_numpy(v), q_offset=off, keys_per_split=span)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        plain = flash_prefill_ref(torch.from_numpy(qs), torch.from_numpy(k), torch.from_numpy(v),
                                  q_offset=off)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t", [64, 65])
def test_split_ref_non_causal_matches_reference_kernel(ref, t):
    jnp, rf = ref
    q, k, v = _inputs(np.random.RandomState(t), 1, t, t)
    want = rf.flash_prefill_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                               q_blk=128, k_blk=128)
    got = flash_prefill_split_ref(*map(torch.from_numpy, (q, k, v)), causal=False,
                                  keys_per_split=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@functools.lru_cache(maxsize=None)
def _cold_call(span, t):
    """The inputs and the cold call of one (span, t), computed once."""
    q, k, v = map(torch.from_numpy, _inputs(np.random.RandomState(t), 2, t, t))
    return q, k, v, flash_prefill_split_ref(q, k, v, keys_per_split=span)


@pytest.mark.parametrize("span,t", [(16, 70), (64, 200), (KEYS_PER_SPLIT, 1100)])
def test_split_ref_rows_bit_identical_across_s_and_offset(span, t):
    """Row q_offset + i of a suffix call equals that row of the cold call bit
    for bit, at offsets on, beside and between the split boundaries."""
    q, k, v, cold = _cold_call(span, t)
    offsets = sorted({1, span - 1, span, span + 1, t // 2, t - 1} - {0})
    for off in offsets:
        suf = flash_prefill_split_ref(q[:, off:], k, v, q_offset=off, keys_per_split=span)
        assert torch.equal(suf, cold[:, off:]), off
    mid = flash_prefill_split_ref(q[:, :t // 2], k[:, :t // 2], v[:, :t // 2],
                                  keys_per_split=span)
    assert torch.equal(mid, cold[:, :t // 2])      # a shorter cold call: its rows too


# ---------------------------------------------------------------------------
# The launch plan of the fp32 kernel
# ---------------------------------------------------------------------------
# (B, S, T, H, KV, hd): chip_smoke's three fp32 K4 shapes, then e2e_prefix's
# donor (cold, prefix + 64), its followers (suffix over the 1056-token
# prefix) and its 384-token chunks, all at qwen3-1.7b's heads
CHIP_SHAPES = [(1, 1500, 1500, 16, 8, 128), (1, 400, 1456, 16, 8, 128),
               (1, 1024, 1024, 8, 1, 256)]
PREFIX_SHAPES = [(1, 1120, 1120, 16, 8, 128), (1, 96, 1152, 16, 8, 128),
                 (1, 200, 1256, 16, 8, 128), (1, 400, 1456, 16, 8, 128),
                 (1, 384, 768, 16, 8, 128), (1, 384, 1152, 16, 8, 128)]


def _blocks_with_work(b, s, t, h, kv, warps, wp, causal):
    """The kernel's own count: a block (tile, split) has work iff the
    tile's last row reaches the split's first key."""
    rows = warps * wp // (h // kv)
    n = 0
    for qt in range(-(-s // rows)):
        last = t - s + min((qt + 1) * rows, s) - 1
        for sp in range(-(-t // KEYS_PER_SPLIT)):
            n += (not causal) or sp * KEYS_PER_SPLIT <= last
    return n * kv * b


@pytest.mark.parametrize("shape", CHIP_SHAPES + PREFIX_SHAPES)
def test_launch_plan_fills_the_card(shape):
    """At least about two blocks an SM of an H100 on every chip shape and
    every e2e_prefix shape, and the grid the kernel will check."""
    b, s, t, h, kv, hd = shape
    plan = launch_plan(b, s, t, h, kv, hd, True, H100_SMS)
    assert plan["blocks"] >= 2 * H100_SMS, plan
    wp = ops.fp32_pairs_per_warp(hd)
    assert plan["pairs"] == plan["warps"] * wp and plan["warps"] in (1, 2, 4)
    assert plan["rows"] == plan["pairs"] // (h // kv)
    assert plan["tiles"] == -(-s // plan["rows"])
    assert plan["splits"] == -(-t // KEYS_PER_SPLIT)
    assert plan["grid"] == plan["tiles"] * plan["splits"] * kv * b
    assert plan["blocks"] == _blocks_with_work(b, s, t, h, kv, plan["warps"], wp, True)


def test_launch_plan_chip_shapes_pinned():
    """The three chip shapes take four-warp blocks (64 pairs; 32 at hd 256)
    and three / three / two key splits."""
    got = [launch_plan(*shape, True, H100_SMS) for shape in CHIP_SHAPES]
    assert [(p["warps"], p["pairs"], p["splits"], p["blocks"]) for p in got] == [
        (4, 64, 3, 744), (4, 64, 3, 312), (4, 32, 2, 384)]


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 3, 8, 16, 33, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_launch_plan_holds_whole_rows(hd, g, causal):
    """A block holds at least one whole row (pairs >= G) for every G the
    wrapper takes, on a big and on a small card, and the fewest warps win
    when no choice fills the card."""
    for sms, s in ((H100_SMS, 37), (8, 700)):
        t = s if not causal else s + 5
        plan = launch_plan(1, s, t if causal else s, g, 1, hd, causal, sms)
        assert plan["pairs"] >= g and plan["rows"] >= 1
        assert plan["blocks"] == _blocks_with_work(1, s, t if causal else s, g, 1,
                                                   plan["warps"], ops.fp32_pairs_per_warp(hd),
                                                   causal)
    small = launch_plan(1, 37, 37, g, 1, hd, causal, H100_SMS)
    if small["blocks"] < 2 * H100_SMS:
        assert small["warps"] == min(w for w in (1, 2, 4, 8)
                                     if w * ops.fp32_pairs_per_warp(hd) >= g)


def test_launch_plan_reads_only_its_arguments(monkeypatch):
    """(B, S, T, H, KV, hd, causal, SM count) and nothing else: no device
    query, no tensor; the same arguments give the same plan."""
    assert list(inspect.signature(launch_plan.__wrapped__).parameters) == [
        "b", "s", "t", "h", "kv", "hd", "causal", "sm_count"]

    def no_device(*args, **kwargs):
        raise AssertionError("launch_plan queried the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "current_device", no_device)
    first = launch_plan.__wrapped__(1, 400, 1456, 16, 8, 128, True, H100_SMS)
    assert first == launch_plan.__wrapped__(1, 400, 1456, 16, 8, 128, True, H100_SMS)
    assert launch_plan.__wrapped__(1, 400, 1456, 16, 8, 128, True, 8)["warps"] == 4
