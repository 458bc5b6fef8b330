"""K11b's and K11d's designs on the CPU, before and beside the card:

- K11d's error-free bf16 split (``microbench_asm.split_bf16x3``): every
  finite f32 in its stated domain (|x| >= 2^-110, and 0) is the exact sum
  of its three pieces, in the order the kernel sums them; each piece is a
  bf16 value; below the domain the split drops bits.
- K11d's arithmetic emulated (``interleave_onehot_split_plain``): with the
  one-hot E it is the interleave bit for bit; with a random E it is within
  1e-5 of max |plain| with the kernel's six passes, and not with the
  leading product alone.
- K11b's thread map (``strided_map``, ``strided_plan``): every output
  element written once, from the right input, with float4 chunks where
  ``wp % 4 == 0`` and the scalar form elsewhere.
- K11a's thread map (``microbench_interleave.asm_map``, ``asm_plan``):
  output-driven, every output element written once from the 58x76 window
  (no padding read), a float4 store a thread, whole warps.
- K11d's tile plan (``onehot_plan``, ``onehot_tiles``): the 464 * 4B x 304
  product covered once, and enough blocks for 132 SMs at b=12 and b=1.
- ``interleave_case`` (seeded, its library the interleave) and
  ``profile_kernels``' K11 cases and K11d's matmul yardstick.
"""

import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu_torch.devtools import microbench_asm as asm
from nlspn_eccv20_tpu_torch.devtools import microbench_interleave as mi
from nlspn_eccv20_tpu_torch.devtools.microbench_interleave import interleave_window
from nlspn_eccv20_tpu_torch.tools import profile_kernels

F32_MAX = np.finfo(np.float32).max


def bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def values_across_exponents(seed, lo, hi):
    """Random 24-bit significands at every binary exponent in [lo, hi],
    both signs."""
    rng = np.random.default_rng(seed)
    e = np.arange(lo, hi + 1)
    m = 1.0 + rng.integers(0, 2 ** 23, (8, e.size)) / 2 ** 23
    x = (m * np.exp2(e.astype(np.float64))).ravel()
    return torch.from_numpy(np.concatenate([x, -x]).astype(np.float32))


def kernel_sum(x):
    x1, x2, x3 = asm.split_bf16x3(x)
    return (x3 + x2) + x1   # the kernel's pass order: smallest piece first


# ---- K11d's split ------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(-110, -60), (-59, 0), (1, 64), (65, 127)])
def test_split_is_exact_across_exponents(lo, hi):
    x = values_across_exponents(lo + 200, lo, hi)
    s = kernel_sum(x)
    assert np.array_equal(bits(s), bits(x))
    for p in asm.split_bf16x3(x):   # each piece is a bf16 value
        assert np.all(bits(p) & 0xFFFF == 0)
        assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)


@pytest.mark.parametrize("x", [0.0, -0.0, F32_MAX, -F32_MAX, 2.0 ** -110, -(2.0 ** -110),
                               np.float32(2.0 ** -110) * np.float32(1 + 2 ** -23),
                               np.nextafter(np.float32(2.0 ** -109), np.float32(0)),
                               np.finfo(np.float32).tiny, 1.0, np.nextafter(np.float32(2), 0)])
def test_split_is_exact_at_the_edges(x):
    t = torch.tensor([x], dtype=torch.float32)
    s = kernel_sum(t)
    assert torch.equal(s, t)   # -0 sums to +0, which compares equal
    if x != 0:
        assert np.array_equal(bits(s), bits(t))
    x1, x2, x3 = asm.split_bf16x3(t)
    assert bool(torch.isfinite(x1).all())   # truncation never reaches infinity
    assert abs(float(x2)) <= abs(float(t)) * 2 ** -7 and abs(float(x3)) <= abs(float(t)) * 2 ** -15


def test_split_pieces_are_normal_down_to_two_to_the_minus_103_and_inexact_below_the_floor():
    x = values_across_exponents(5, -103, -60)
    tiny = np.finfo(np.float32).tiny
    for p in asm.split_bf16x3(x):
        a = p.abs().numpy()
        assert np.all((a == 0) | (a >= tiny))
    # below 2^-110 a value's last bits lie under bf16's smallest subnormal
    below = torch.tensor([np.float32(2.0 ** -115) * np.float32(1 + 2 ** -23)])
    assert not torch.equal(kernel_sum(below), below)


def test_passes_are_the_products_of_piece_orders_up_to_four_smallest_first():
    assert asm.ONEHOT_PASSES == ((3, 1), (2, 2), (1, 3), (2, 1), (1, 2), (1, 1))
    assert sorted(asm.ONEHOT_PASSES) == sorted(
        (i, j) for i in (1, 2, 3) for j in (1, 2, 3) if i + j <= 4)
    assert [i + j for i, j in asm.ONEHOT_PASSES] == sorted(
        (i + j for i, j in asm.ONEHOT_PASSES), reverse=True)


# ---- K11d's arithmetic, emulated ---------------------------------------------

@pytest.mark.parametrize("b,hp,wp", [(1, 64, 128), (2, 59, 77), (1, 58, 76)])
def test_split_emulation_with_the_onehot_e_is_the_interleave(b, hp, wp):
    (ph, e), library = asm.interleave_case(torch.Generator().manual_seed(b + hp), "cpu", b,
                                           hp, wp)
    out = asm.interleave_onehot_split_plain(ph, e)
    assert np.array_equal(bits(out), bits(library()))
    assert torch.equal(out, asm.interleave_onehot_plain(ph, e))


@pytest.mark.parametrize("b,hp,wp", [(1, 64, 128), (2, 59, 77)])
def test_split_emulation_with_a_random_e_is_within_1e_5(b, hp, wp):
    (ph, e), _ = asm.interleave_case(torch.Generator().manual_seed(7), "cpu", b, hp, wp,
                                     random_e=True)
    want = asm.interleave_onehot_plain(ph, e)
    scale = want.abs().max()
    got = asm.interleave_onehot_split_plain(ph, e)
    assert (got - want).abs().max() <= 1e-5 * scale
    # the leading products alone, a bf16 product of the rounded values, miss it
    lead = asm.interleave_onehot_split_plain(ph, e, passes=((1, 1),))
    assert (lead - want).abs().max() > 1e-5 * scale


def test_split_emulation_keeps_every_plane_apart():
    """One phase plane set to ones, the rest zero: only its (4i + a, 4j + b)
    outputs are ones."""
    ph = torch.zeros(1, 128, 58, 76)
    p = (4 * 2 + 3) * 8 + 5   # a = 2, b = 3, c = 5
    ph[0, p] = 1.0
    out = asm.interleave_onehot_split_plain(ph, asm.onehot_expansion())
    want = torch.zeros(1, 8, 232, 304)
    want[0, 5, 2::4, 3::4] = 1.0
    assert torch.equal(out, want)


# ---- K11b's thread map -------------------------------------------------------

@pytest.mark.parametrize("hp,wp", [(64, 128), (58, 76), (59, 77), (60, 78)])
def test_k11b_thread_map_writes_every_output_once_from_its_input(hp, wp):
    b = 2
    src, dst = asm.strided_map(b, hp, wp)
    assert np.array_equal(np.bincount(dst.ravel(), minlength=b * 8 * 232 * 304),
                          np.ones(b * 8 * 232 * 304, np.int64))
    ph = np.random.default_rng(hp * wp).standard_normal((b, 128, hp, wp)).astype(np.float32)
    out = np.full(b * 8 * 232 * 304, np.nan, np.float32)
    out[dst.ravel()] = ph.ravel()[src.ravel()]
    assert np.array_equal(out, interleave_window(torch.from_numpy(ph)).numpy().ravel())
    blocks, threads, vec = asm.strided_plan(b, hp, wp)
    assert vec == (wp % 4 == 0) and not asm.strided_plan(b, hp, wp, aligned=False)[2]
    assert blocks * threads >= src.shape[0] > (blocks - 1) * threads
    # the float4 chunks: four adjacent inputs of a plane, and the 16
    # contiguous outputs of a thread as four 16-byte stores
    assert np.all(np.diff(src.reshape(-1, 4, 4), axis=2) == 1)
    if vec:
        assert np.all(src[:, ::4] % 4 == 0)
    assert np.all(dst.min(axis=1) % 4 == 0)
    assert np.all(np.sort(dst, axis=1) - dst.min(axis=1, keepdims=True) == np.arange(16))


def test_k11b_plan_gives_every_sm_two_blocks_at_b1():
    blocks, threads, _ = asm.strided_plan(1, 64, 128)
    assert blocks * threads >= 1 * 8 * 58 * 4 * 19 == 35264
    assert blocks >= 2 * 132


# ---- K11a's thread map -------------------------------------------------------

@pytest.mark.parametrize("hp,wp", [(64, 128), (58, 76), (59, 77), (60, 78)])
def test_k11a_thread_map_writes_every_output_once_from_the_window(hp, wp):
    b = 2
    src, dst = mi.asm_map(b, hp, wp)
    assert np.array_equal(np.bincount(dst.ravel(), minlength=b * 8 * 232 * 304),
                          np.ones(b * 8 * 232 * 304, np.int64))
    # no read of the padding: every source lies in its plane's 58x76 window
    assert np.all(src % wp < 76) and np.all((src // wp) % hp < 58)
    ph = np.random.default_rng(hp + wp).standard_normal((b, 128, hp, wp)).astype(np.float32)
    out = np.full(b * 8 * 232 * 304, np.nan, np.float32)
    out[dst.ravel()] = ph.ravel()[src.ravel()]
    assert np.array_equal(out, interleave_window(torch.from_numpy(ph)).numpy().ravel())
    # output-driven: a thread's four outputs are one aligned float4 of a row,
    # its four sources the phases b of one window element, 8 planes apart
    assert np.all(dst[:, 0] % 4 == 0) and np.all(np.diff(dst, axis=1) == 1)
    assert np.all(np.diff(src, axis=1) == 8 * hp * wp)


def test_k11a_plan_is_whole_warps_whose_loads_are_row_pieces():
    (gx, gy), threads = mi.asm_plan(12)
    assert (gx, gy, threads) == (29, 96, 608) and threads % 32 == 0
    src, dst = mi.asm_map(1, 64, 128)
    # a warp's 32 threads: consecutive columns of one phase row (or of two,
    # where the warp crosses an output row), so each of its four loads reads
    # one or two runs of contiguous floats
    steps = np.diff(src[:, 0].reshape(-1, 32), axis=1)
    assert np.all((steps != 1).sum(axis=1) <= 1)
    # and its float4 stores 512 contiguous bytes: output rows are contiguous
    assert np.all(np.diff(dst[:, 0].reshape(-1, 32), axis=1) == 4)


# ---- K11d's tile plan ----------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2, 4, 5, 12])
def test_k11d_tiles_cover_the_product_once(batch):
    rows = 464 * 4 * batch
    hits = np.zeros((rows, 304), np.int32)
    p = asm.onehot_plan(batch)
    for r0, nr, c0, nc in asm.onehot_tiles(batch):
        assert (nr, nc) == (p["bm"], p["bn"])
        hits[r0:r0 + nr, c0:c0 + nc] += 1
    assert np.all(hits == 1)
    # the k-parts of a tile's cluster: every k-step once, each long enough
    # to fill the three-stage pipeline
    steps = [s for s0, n in p["kparts"] for s in range(s0, s0 + n)]
    assert steps == list(range(19)) and min(n for _, n in p["kparts"]) >= 2


@pytest.mark.parametrize("batch,plan,bm,kparts,blocks", [
    (1, "split", 64, 4, 232), (4, "split", 64, 4, 928), (5, "split", 64, 4, 1160),
    (12, "large", 128, 1, 348)])
def test_k11d_plan_fills_132_sms(batch, plan, bm, kparts, blocks):
    p = asm.onehot_plan(batch)
    assert (p["plan"], p["bm"], len(p["kparts"]), p["blocks"]) == (plan, bm, kparts, blocks)
    assert p["blocks"] >= 132
    assert p["threads"] == 2 * p["bm"]   # warpgroups of 64 rows, a warp 16
    assert p["bn"] == 152 and p["grid"][0] == 2 * kparts


# ---- the case builder and the profiling tool's K11 cases -----------------------

@pytest.mark.parametrize("random_e", [False, True])
def test_interleave_case_is_seeded_and_its_library_is_the_interleave(random_e):
    (ph, e), library = asm.interleave_case(torch.Generator().manual_seed(4), "cpu", 2, 59, 77,
                                           random_e=random_e)
    (ph2, e2), _ = asm.interleave_case(torch.Generator().manual_seed(4), "cpu", 2, 59, 77,
                                       random_e=random_e)
    assert ph.shape == (2, 128, 59, 77) and e.shape == asm.E_SHAPE
    assert torch.equal(ph, ph2) and torch.equal(e, e2)
    assert torch.equal(library(), interleave_window(ph))
    assert torch.equal(e, asm.onehot_expansion()) != random_e
    assert bool(ph[:, :, 58:].abs().sum() > 0)   # the padding is random too


def test_profile_kernels_times_k11_at_the_three_shapes():
    cases = [c for c in profile_kernels.CASES if c[0].startswith("K11")]
    assert sorted(cases) == sorted((k, b, hp, wp, {}) for k in ("K11a", "K11b", "K11d")
                                   for b, hp, wp in ((12, 64, 128), (1, 64, 128), (12, 59, 77)))
    assert all(k in profile_kernels.SOURCES for k, *_ in profile_kernels.CASES)


def test_k11d_matmul_yardstick_computes_the_same_rows():
    (ph, e), library = asm.interleave_case(torch.Generator().manual_seed(2), "cpu", 2, 61, 80)
    d = profile_kernels.onehot_matmul(ph, e)()
    assert d.shape == (8, 464, 304)
    assert torch.equal(asm.onehot_rows_to_output(d), library())
