"""K9b's design on the CPU, before and beside the card:

- its tile and slice plan (``small_conv3x3.bwd_plan``, mirroring
  ``csrc/small_conv3x3_bwd.cu``): the dx pass covers every pixel and
  channel once, the dW pass every 4x16 tile, (tap, k) row and channel
  once, and both fit the card's shared memory and registers at K = 1, 10,
  26 and 32;
- its arithmetic emulated in the kernel's summation order
  (``small_conv3x3_bwd_split_plain``: the 3xTF32 split, k-steps of 8, each
  dW tile summed apart, the slices added as ``reduce_partials`` does):
  within 1e-5 of ``small_conv3x3_bwd_plain`` run in float64 (and not with
  the heads' product alone), and against the JAX ``_bwd_pallas`` in
  interpret mode at ``test_torch_small_conv3x3.py``'s tolerance;
- the input cases (``small_conv3x3_case``, ``small_conv3x3_bwd_case``) and
  ``profile_kernels``' K9 and K9b cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlspn_eccv20_tpu.ops.pallas.small_conv3x3 as sc
from nlspn_eccv20_tpu_torch.ops.kernels import small_conv3x3 as k9
from nlspn_eccv20_tpu_torch.tools import profile_kernels

SHAPES = [(12, 228, 304), (1, 228, 304), (2, 57, 75)]   # the profiled and checked planes


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(sc, "FORCE_PALLAS_INTERPRET", True)


def _inputs(seed, b, h, w, ca, cb, k):
    rng = np.random.default_rng(seed)

    def randn(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    return (randn(b, k, h, w), randn(b, ca, h, w), randn(b, cb, h, w),
            randn(k, ca + cb, 3, 3, std=(9 * (ca + cb)) ** -0.5))


def _rel(got, want):
    return max(float((a.double() - r).abs().max() / r.abs().max()) for a, r in zip(got, want))


# ---- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 10, 26, 32])
@pytest.mark.parametrize("b,h,w,ca,cb", [(1, 19, 37, 24, 16), (2, 9, 16, 192, 64),
                                         (1, 8, 75, 130, 6)])
def test_dx_tiles_cover_every_pixel_and_channel_once(k, b, h, w, ca, cb):
    p = k9.bwd_plan(b, h, w, ca, cb, k, sms=4)
    th, tw = k9.DX_TILE
    tiles_x = -(-w // tw)
    hits = np.zeros((b, ca + cb, -(-h // th) * th, tiles_x * tw), np.int32)
    for chunk in range(p["dx_chunks"]):
        c0 = chunk * p["dx_nc"]
        for blk in range(p["dx_blocks"]):
            for t in range(blk, p["dx_tiles"], p["dx_blocks"]):
                n, r = divmod(t, p["dx_tiles"] // b)
                y0, x0 = (r // tiles_x) * th, (r % tiles_x) * tw
                hits[n, c0:c0 + p["dx_nc"], y0:y0 + th, x0:x0 + tw] += 1
    assert np.all(hits[:, :, :h, :w] == 1)
    # the (tap, k) rows of the k-steps: tap * K + k, each once, padded to 8
    assert p["ksteps"] * 8 >= 9 * k > (p["ksteps"] - 1) * 8
    rows = sorted(tap * k + kk for tap in range(9) for kk in range(k))
    assert rows == list(range(9 * k))


@pytest.mark.parametrize("k", [1, 10, 26, 32])
@pytest.mark.parametrize("b,h,w,c", [(1, 19, 37, 40), (2, 9, 16, 256), (1, 8, 75, 136)])
def test_wgrad_slices_cover_every_tile_row_and_channel_once(k, b, h, w, c):
    p = k9.bwd_plan(b, h, w, c - 7, 7, k, sms=4)
    n_t, n_s = p["wg_tiles"], p["slices"]
    assert n_t == b * -(-h // k9.WG_TILE[0]) * -(-w // k9.WG_TILE[1])
    tiles = [t for s in range(n_s) for t in range(n_t * s // n_s, n_t * (s + 1) // n_s)]
    assert tiles == list(range(n_t))
    assert 1 <= n_s <= k9.RED_CHUNK   # one pass of the reduction
    hits = np.zeros((p["mchunks"] * k9.WG_MR, p["cchunks"] * k9.WG_NC), np.int32)
    for m in range(p["mchunks"]):
        for cc in range(p["cchunks"]):
            hits[m * k9.WG_MR:(m + 1) * k9.WG_MR, cc * k9.WG_NC:(cc + 1) * k9.WG_NC] += 1
    assert np.all(hits == 1) and hits.shape[0] >= 9 * k and hits.shape[1] >= c
    assert (p["mchunks"] - 1) * k9.WG_MR < 9 * k


@pytest.mark.parametrize("k", [1, 10, 26, 32])
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_plan_fits_the_cards_shared_memory_and_registers(k, b, h, w):
    p = k9.bwd_plan(b, h, w, k9.HEADS_CA, k9.HEADS_CB, k)
    assert p["dx_smem"] <= k9.BLOCK_SMEM_MAX and p["wg_smem"] <= k9.BLOCK_SMEM_MAX
    assert p["dx_per_sm"] * (p["dx_smem"] + 1024) <= k9.CARD_SMEM
    # 128 channels a dx block wherever two such blocks fit an SM
    assert (p["dx_nc"] == 128) == (2 * (k9._dx_smem(128, k, p["ksteps"]) + 1024)
                                   <= k9.CARD_SMEM)
    assert p["threads"] * p["regs"] * k9.BWD_MIN_BLOCKS <= 65536 and p["regs"] == 128
    # the heads' K = 10: two blocks of each pass an SM; on NYU's plane both
    # grids fill them, at b=1 too
    if k == 10:
        assert p["dx_nc"] == 128 and p["dx_per_sm"] == 2
        assert 2 * (p["wg_smem"] + 1024) <= k9.CARD_SMEM
        if h == 228:
            assert p["dx_chunks"] * p["dx_blocks"] == 2 * k9.CARD_SMS
            assert p["slices"] * p["mchunks"] * p["cchunks"] >= 2 * k9.CARD_SMS - 8


# ---- the arithmetic --------------------------------------------------------------

def test_tf32_split_truncates_and_keeps_the_largest_f32_finite():
    f32 = np.finfo(np.float32)
    v = torch.tensor([1.0, -1.0 / 3.0, 3.0e-30, f32.max, -f32.max, 0.0, 1.0 + 2 ** -23])
    hi, lo = k9._tf32_split(v)
    assert np.all(hi.view(torch.int32).numpy() & 0x1FFF == 0)
    assert np.all(lo.view(torch.int32).numpy() & 0x1FFF == 0)
    assert bool(torch.isfinite(hi).all() and torch.isfinite(lo).all())
    assert torch.all(hi.abs() <= v.abs())   # truncated toward zero, never up
    rest = (v.double() - hi.double() - lo.double()).abs()
    assert torch.all(rest <= v.double().abs() * 2.0 ** -20)


@pytest.mark.parametrize("b,h,w,ca,cb,k", [
    (1, 9, 20, 24, 16, 10),     # the heads' K
    (2, 7, 19, 40, 9, 26),      # the offset heads' K, odd width
    (1, 10, 33, 13, 3, 1),
    (1, 5, 21, 7, 9, 32),       # MAX_K: two 128-row chunks of dW
])
def test_split_emulation_is_within_1e_5_of_float64(b, h, w, ca, cb, k):
    g, xa, xb, wk = _inputs(b + h + k, b, h, w, ca, cb, k)
    want = k9.small_conv3x3_bwd_plain(*(t.double() for t in (g, xa, xb, wk)))
    assert _rel(k9.small_conv3x3_bwd_split_plain(g, xa, xb, wk, sms=2), want) <= 1e-5
    # the heads' product alone, TF32 to ~11 bits, misses it
    assert _rel(k9.small_conv3x3_bwd_split_plain(g, xa, xb, wk, sms=2, passes=1), want) > 1e-5


@pytest.mark.parametrize("shape", [(2, 16, 24, 16, 8, 10), (1, 9, 31, 8, 8, 26)])
def test_split_emulation_matches_the_tpu_kernel_in_interpret_mode(shape):
    """Against ``_bwd_pallas`` in interpret mode at 2e-4, the tolerance
    ``test_torch_small_conv3x3.py`` holds the plain backward to."""
    b, h, w, ca, cb, k = shape
    g, xa, xb, wk = _inputs(9, b, h, w, ca, cb, k)
    nhwc = (lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy()))
    ref = sc._bwd_pallas(nhwc(xa), nhwc(xb), jnp.asarray(wk.permute(2, 3, 1, 0).numpy()),
                         jnp.zeros(k), jnp.asarray(g.numpy()))   # g planar, (B, K, H, W)
    got = k9.small_conv3x3_bwd_split_plain(g, xa, xb, wk)
    want = [np.asarray(ref[0]).transpose(0, 3, 1, 2), np.asarray(ref[1]).transpose(0, 3, 1, 2),
            np.asarray(ref[2]).transpose(3, 2, 0, 1), np.asarray(ref[3])]
    for a, r in zip(got, want):
        assert a.shape == r.shape
        assert np.max(np.abs(a.numpy() - r)) / np.max(np.abs(r)) <= 2e-4


# ---- the input cases and the profiling tool ----------------------------------------

def test_cases_are_seeded_and_their_library_computes_the_same_function():
    gen = lambda: torch.Generator().manual_seed(3)
    (g, xa, xb, wk), library = k9.small_conv3x3_bwd_case(gen(), "cpu", 2, 9, 11, k=4)
    (g2, *_), _ = k9.small_conv3x3_bwd_case(gen(), "cpu", 2, 9, 11, k=4)
    assert g.shape == (2, 4, 9, 11) and xa.shape == (2, k9.HEADS_CA, 9, 11)
    assert xb.shape == (2, k9.HEADS_CB, 9, 11) and torch.equal(g, g2)
    assert _rel(library(), k9.small_conv3x3_bwd_plain(g.double(), xa.double(), xb.double(),
                                                      wk.double())) <= 1e-4
    (xa, xb, wk, bk), library = k9.small_conv3x3_case(gen(), "cpu", 1, 9, 11, k=4)
    assert torch.equal(library(), k9.small_conv3x3_plain(xa, xb, wk, bk))


def test_profile_kernels_times_k9_and_k9b_at_the_four_shapes():
    """The four shapes of both; K9 also at the serving shapes, b=1 and b=4
    of 256x320."""
    for name, src in (("K9", "small_conv3x3"), ("K9b", "small_conv3x3_bwd")):
        cases = [c for c in profile_kernels.CASES if c[0] == name]
        serving = [(name, 1, 256, 320, {"k": 10}), (name, 4, 256, 320, {"k": 10})]
        assert cases == [(name, 12, 228, 304, {"k": 10}), (name, 1, 228, 304, {"k": 10}),
                         (name, 2, 57, 75, {"k": 26}), (name, 1, 228, 304, {"k": 1})] + (
            serving if name == "K9" else [])
        assert profile_kernels.SOURCES[name] == [src]
