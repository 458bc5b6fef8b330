"""K9's redesign on the CPU, before and beside the card
(``csrc/small_conv3x3.cu``: an implicit GEMM on ``wgmma`` in 3xTF32):

- its launch plan (``small_conv3x3.fwd_plan``): the block tiles and the
  M-tiles of each warpgroup cover every pixel once, the channel splits
  every channel once, and a block's three stages and its sums fit the
  card's shared memory and registers, two blocks an SM, at K = 1 to 32;
- its arithmetic emulated in the kernel's order
  (``small_conv3x3_split_plain``: chunks of 8 channels summed apart over
  their 9 taps, a k-step a tap, the splits added in order): within 1e-5 of
  ``small_conv3x3_plain`` run in float64 (and not with the heads' product
  alone), and against the JAX ``_fwd_pallas`` in interpret mode at
  ``test_torch_small_conv3x3.py``'s forward tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlspn_eccv20_tpu.ops.pallas.small_conv3x3 as sc
from nlspn_eccv20_tpu_torch.ops.kernels import small_conv3x3 as k9


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(sc, "FORCE_PALLAS_INTERPRET", True)


def _inputs(seed, b, h, w, ca, cb, k):
    rng = np.random.default_rng(seed)

    def randn(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    return (randn(b, ca, h, w), randn(b, cb, h, w),
            randn(k, ca + cb, 3, 3, std=(9 * (ca + cb)) ** -0.5), randn(k, std=0.1))


def _tile_pixels(mt):
    """(row, column) of each M-tile pixel of a block: warpgroup g's M-tile m,
    warp row wr, A rows gid and gid + 8 (h = 0, 1) at pixels 2 gid + h, as
    the kernel's abase and epilogue place them."""
    out = []
    for g in range(2):
        for m in range(mt):
            for wr in range(4):
                for gid in range(8):
                    for h in range(2):
                        out.append((4 * (g + 2 * (m // 2)) + wr, 16 * (m % 2) + 2 * gid + h))
    return out


# ---- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 10, 17, 26, 32])
@pytest.mark.parametrize("b,h,w,ca,cb,sms", [(1, 19, 37, 24, 16, 4), (2, 9, 16, 192, 64, 132),
                                             (1, 8, 75, 130, 6, 2), (2, 57, 75, 192, 64, 132)])
def test_tiles_and_splits_cover_every_pixel_and_channel_once(k, b, h, w, ca, cb, sms):
    p = k9.fwd_plan(b, h, w, ca, cb, k, sms)
    tr, tc = p["tile"]
    pix = _tile_pixels(p["mt"])
    assert sorted(pix) == [(r, c) for r in range(tr) for c in range(tc)]   # each once
    gx, gy, gz = p["grid"]
    assert gz == b * p["splits"] and gx * gy * b == p["tiles"]
    c = ca + cb
    hits = np.zeros((b, c, gy * tr, gx * tc), np.int32)
    for z in range(gz):
        n, split = divmod(z, p["splits"])
        lo = split * p["chunks_per"]
        hi = min(lo + p["chunks_per"], p["chunks"])
        assert lo < hi   # no split is empty
        c0, c1 = k9.FWD_CH * lo, min(k9.FWD_CH * hi, c)
        for by in range(gy):
            for bx in range(gx):
                hits[n, c0:c1, by * tr:(by + 1) * tr, bx * tc:(bx + 1) * tc] += 1
    assert np.all(hits[:, :, :h, :w] == 1)
    assert 1 <= p["splits"] <= k9.FWD_MAX_SPLIT
    assert p["n"] % 8 == 0 and p["n"] - 8 < k <= p["n"]


@pytest.mark.parametrize("k", list(range(1, 33)))
def test_plan_fits_the_cards_shared_memory_and_registers(k):
    p = k9.fwd_plan(12, 228, 304, k9.HEADS_CA, k9.HEADS_CB, k)
    assert p["smem"] <= k9.BLOCK_SMEM_MAX
    assert k9.FWD_MIN_BLOCKS * (p["smem"] + 1024) <= k9.CARD_SMEM   # two blocks an SM
    assert p["threads"] * p["regs"] * k9.FWD_MIN_BLOCKS <= 65536 and p["regs"] == 128
    # a thread's running sums, a chunk's fresh sums and two fragment
    # buffers (heads and rests, 4 each) leave a third of the 128 registers
    assert 2 * p["mt"] * p["n"] // 2 + 2 * 8 <= 80


def test_plan_at_the_timed_shapes():
    """NYU's b=12 fills the card without splits; the serving and small
    planes split their channels, the split weights and partial sums in
    scratch."""
    ca, cb = k9.HEADS_CA, k9.HEADS_CB
    p = k9.fwd_plan(12, 228, 304, ca, cb, 10)
    assert (p["n"], p["mt"], p["tile"], p["splits"], p["grid"]) == (16, 4, (16, 32), 1,
                                                                     (10, 15, 12))
    assert p["scratch"] == 32 * 9 * 16 * 16
    p = k9.fwd_plan(1, 256, 320, ca, cb, 10)
    assert (p["tiles"], p["splits"], p["chunks_per"]) == (160, 3, 11)
    assert p["scratch"] == 32 * 9 * 16 * 16 + 3 * 10 * 256 * 320
    p = k9.fwd_plan(2, 57, 75, ca, cb, 26)
    assert (p["n"], p["mt"], p["tile"], p["splits"]) == (32, 2, (8, 32), 5)


# ---- the arithmetic --------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,ca,cb,k,sms", [
    (1, 9, 20, 24, 16, 10, 132),   # the heads' K
    (2, 7, 19, 40, 9, 26, 2),      # the offset heads' K, odd width, channel splits
    (1, 10, 33, 13, 3, 1, 132),
    (1, 5, 21, 7, 9, 32, 3),       # MAX_K
])
def test_split_emulation_is_within_1e_5_of_float64(b, h, w, ca, cb, k, sms):
    xa, xb, wk, bk = _inputs(b + h + k, b, h, w, ca, cb, k)
    want = k9.small_conv3x3_plain(*(t.double() for t in (xa, xb, wk, bk)))

    def rel(got):
        return float((got.double() - want).abs().max() / want.abs().max())

    got = k9.small_conv3x3_split_plain(xa, xb, wk, bk, sms=sms)
    assert got.shape == want.shape and rel(got) <= 1e-5
    # the heads' product alone, TF32 to ~11 bits, misses it
    assert rel(k9.small_conv3x3_split_plain(xa, xb, wk, bk, sms=sms, passes=1)) > 1e-5


@pytest.mark.parametrize("shape", [(2, 16, 24, 16, 8, 10), (1, 9, 31, 8, 8, 26)])
def test_split_emulation_matches_the_tpu_kernel_in_interpret_mode(shape):
    """Against ``_fwd_pallas`` in interpret mode at 1e-5, the tolerance
    ``test_torch_small_conv3x3.py`` holds the plain forward to."""
    b, h, w, ca, cb, k = shape
    xa, xb, wk, bk = _inputs(11, b, h, w, ca, cb, k)
    nhwc = (lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy()))
    ref = np.asarray(sc._fwd_pallas(nhwc(xa), nhwc(xb),
                                    jnp.asarray(wk.permute(2, 3, 1, 0).numpy()),
                                    jnp.asarray(bk.numpy())))   # planar (B, K, H, W)
    got = k9.small_conv3x3_split_plain(xa, xb, wk, bk, sms=2).numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-5
