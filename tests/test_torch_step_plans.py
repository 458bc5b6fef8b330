"""The launch plans of the local step (K1), its backward (K1b) and the
offset step (K7), the input cases on which the card checks and times
them, their PyTorch yardsticks, and the Predictor's weights.

The plans are plain Python that the CUDA wrappers follow, so they are held
here at NYU's 228x304 (and a 230x306 plane whose sides are no multiple of
the tiles), the serving bucket 256x320, KITTI's 240x1216 and a 5x3 plane
smaller than one tile: K1's tiles cover every pixel once, a block is
interior exactly when its staged region (the tile grown by r rows and r
rounded up to 4 columns) lies inside the plane, that region holds every
clamped tap of its pixels, the float4 form is taken exactly on planes whose
width is a multiple of 4, and a b=1 serving plane gives every SM a block;
K1b's tiles cover every pixel once, everything a block reads lies in its
staged region, and a block is interior (no clamp,
no edge test) exactly when every tap and every source of its pixels lies
inside the plane; K7's tiles cover every pixel once, a
block is interior exactly when its staged region lies inside the plane,
and every tap of an offset clamped to [-R, R] lies in the staged region.
The yardsticks (the PyTorch call sequences timed beside K1 and K1b) are
held against the plain versions that the card holds the kernels against.
"""

import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import (
    FWD_PIXELS, FWD_THREAD_ROWS, STAGE_RADIUS, deform_prop, deform_prop_case,
    deform_prop_fwd_plain, fwd_blocks, fwd_plan)
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
    BWD_TILE, STEP_COLS, STEP_ROWS, bwd_blocks, prop_step, prop_step_bwd,
    prop_step_bwd_case, prop_step_bwd_plain, prop_step_case, prop_step_plain, step_blocks,
    step_pad, step_rows, step_vector)
from nlspn_eccv20_tpu_torch.serve import Predictor
from nlspn_eccv20_tpu_torch.utils.weights import randomize_

H100_SMS = 132
SHAPES = [(228, 304), (230, 306), (256, 320), (240, 1216), (5, 3)]


def _in(lo, hi, n):
    return lo >= 0 and hi <= n - 1


@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("h,w", SHAPES)
def test_step_bwd_blocks_cover_once_stage_and_classify(h, w, kernel):
    r = kernel // 2
    rows, cols = BWD_TILE
    cover = np.zeros((h, w), np.int64)
    for y0, x0, interior in bwd_blocks(h, w, kernel):
        cover[y0:y0 + rows, x0:x0 + cols] += 1
        # every pixel of the tile is in the plane and no tap (o + d) or
        # source (o - d) of any of them leaves it: then none is an edge
        # pixel, and no term needs a clamp or a test
        ys = np.arange(y0, y0 + rows)[:, None] + np.arange(-r, r + 1)
        xs = np.arange(x0, x0 + cols)[:, None] + np.arange(-r, r + 1)
        inside = _in(ys.min(), ys.max(), h) and _in(xs.min(), xs.max(), w)
        assert interior == inside
        if interior:
            assert y0 > 0 and y0 + rows < h and x0 > 0 and x0 + cols < w
        # what the block reads lies in its staged region (the tile grown by
        # r): the clamped taps of its pixels, and the outputs whose clamped
        # taps reach a pixel on the plane's edge (the replicate padding's fold)
        for lo, n, size in ((y0, min(rows, h - y0), h), (x0, min(cols, w - x0), w)):
            pix = np.arange(lo, lo + n)
            taps = np.clip(pix[:, None] + np.arange(-r, r + 1), 0, size - 1)
            assert taps.min() >= lo - r and taps.max() <= lo + n - 1 + r
            outs = np.arange(size)
            for s in pix[(pix == 0) | (pix == size - 1)]:
                for d in range(-r, r + 1):
                    reach = outs[np.clip(outs + d, 0, size - 1) == s]
                    assert reach.size == 0 or (reach.min() >= lo - r
                                               and reach.max() <= lo + n - 1 + r)
    assert (cover == 1).all()


@pytest.mark.parametrize("h,w,interior", [
    (228, 304, 216),            # the default train step: 290 blocks an image
    (230, 306, 216),
    (256, 320, 240),
    (240, 1216, 1008),          # KITTI
    (5, 3, 0),
])
def test_step_bwd_interior_blocks(h, w, interior):
    assert sum(i for *_, i in bwd_blocks(h, w, 3)) == interior


STEP_SHAPES = SHAPES + [(57, 75)]


@pytest.mark.parametrize("rows", STEP_ROWS)
@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("h,w", STEP_SHAPES)
def test_step_blocks_cover_once_stage_and_classify(h, w, kernel, rows):
    r, pad = kernel // 2, step_pad(kernel)
    assert pad >= r and pad % 4 == 0
    cover = np.zeros((h, w), np.int64)
    for y0, x0, interior in step_blocks(h, w, kernel, rows):
        cover[y0:y0 + rows, x0:x0 + STEP_COLS] += 1
        sy0, sy1 = y0 - r, y0 + rows - 1 + r            # staged rows
        sx0, sx1 = x0 - pad, x0 + STEP_COLS - 1 + pad    # staged columns
        assert interior == (_in(sy0, sy1, h) and _in(sx0, sx1, w))
        if interior:   # every store of the tile lands in the plane
            assert y0 + rows <= h and x0 + STEP_COLS <= w
        # the clamped taps of the block's pixels lie in its staged region
        # (a staged cell holds the clamped position's value)
        for lo, n, size, s0, s1 in ((y0, min(rows, h - y0), h, sy0, sy1),
                                    (x0, min(STEP_COLS, w - x0), w, sx0, sx1)):
            pix = np.arange(lo, lo + n)
            taps = pix[:, None] + np.arange(-r, r + 1)
            assert taps.min() >= s0 and taps.max() <= s1
            assert np.clip(taps, 0, size - 1).min() >= max(s0, 0)
        # the float4 form's 4-column chunks of the staged rows start on a
        # multiple of 4: 16-byte copies where the chunk lies in the plane
        assert (sx0 % 4, (sx1 + 1) % 4) == (0, 0)
    assert (cover == 1).all()


@pytest.mark.parametrize("w,vector", [(304, True), (320, True), (1216, True),
                                      (306, False), (75, False), (3, False)])
def test_step_takes_the_float4_form_on_aligned_rows(w, vector):
    assert step_vector(w) == vector
    if vector:   # a thread's 4 pixels are all in the row or all past it
        xs = np.arange(0, -(-w // STEP_COLS) * STEP_COLS, 4)
        assert ((xs < w) == (xs + 3 < w)).all()


@pytest.mark.parametrize("b,h,w,rows,blocks", [
    (1, 256, 320, 8, 160),      # serving b=1: every one of 132 SMs a block
    (4, 256, 320, 8, 640),
    (12, 228, 304, 16, 900),    # the default train step
    (1, 240, 1216, 8, 570),     # KITTI
    (12, 230, 306, 16, 900),
    (1, 5, 3, 8, 1),
])
def test_step_rows_keep_every_sm_busy(b, h, w, rows, blocks):
    assert step_rows(b, h, w, H100_SMS) == rows
    assert b * len(list(step_blocks(h, w, 3, rows))) == blocks
    if (h, w) == (256, 320):
        assert blocks >= H100_SMS


@pytest.mark.parametrize("h,w,kernel,rows,interior", [
    (228, 304, 3, 16, 39),      # the train step: 13 of 15 rows x 3 of 5 columns
    (256, 320, 3, 8, 90),
    (240, 1216, 3, 8, 476),
    (230, 306, 3, 16, 39),
    (256, 320, 5, 8, 90),
    (5, 3, 3, 8, 0),
])
def test_step_interior_blocks(h, w, kernel, rows, interior):
    assert sum(i for *_, i in step_blocks(h, w, kernel, rows)) == interior


@pytest.mark.parametrize("radius", [0, 1, 4, None])
@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("h,w", SHAPES)
def test_fwd_plan_stages_every_clamped_tap(h, w, kernel, radius):
    r = kernel // 2
    big = STAGE_RADIUS if radius is None else radius
    # offsets in [-R, R]: their floors, and the +1 of the 2x2 corner
    floors = np.unique(np.floor(np.linspace(-big, big, 8 * big + 1)))
    for b in (1, 4, 12):
        rows, cols, margin = fwd_plan(b, h, w, kernel, radius, H100_SMS)
        assert rows // FWD_THREAD_ROWS in FWD_PIXELS and cols == 32
        assert margin == r + big + 1
        cover = np.zeros((h, w), np.int64)
        for y0, x0, interior in fwd_blocks(h, w, rows, cols, margin):
            cover[y0:y0 + rows, x0:x0 + cols] += 1
            sy0, sy1 = y0 - margin, y0 + rows - 1 + margin    # staged rows
            sx0, sx1 = x0 - margin, x0 + cols - 1 + margin
            assert interior == (_in(sy0, sy1, h) and _in(sx0, sx1, w))
            ys = np.arange(y0, min(y0 + rows, h))   # the pixels the kernel runs
            xs = np.arange(x0, min(x0 + cols, w))
            for pix, lo, hi in ((ys, sy0, sy1), (xs, sx0, sx1)):
                taps = (pix[:, None, None] + np.arange(-r, r + 1)[:, None]
                        + floors[None, None, :])
                assert taps.min() >= lo and taps.max() + 1 <= hi
        assert (cover == 1).all()


@pytest.mark.parametrize("b,h,w,radius,rows", [
    (1, 256, 320, None, 8),     # serving b=1: 320 blocks
    (4, 256, 320, None, 32),
    (12, 228, 304, 4, 32),      # the offset train step
    (1, 240, 1216, None, 32),   # KITTI
    (1, 5, 3, 4, 8),
])
def test_fwd_plan_picks_the_tile(b, h, w, radius, rows):
    assert fwd_plan(b, h, w, 3, radius, H100_SMS)[:2] == (rows, 32)


def test_fwd_plan_caps_the_staging_radius():
    assert fwd_plan(1, 256, 320, 3, 40, H100_SMS)[2] == 1 + 8 + 1


@pytest.mark.parametrize("kernel,clip", [(3, False), (5, True)])
def test_step_cases_are_seeded_and_their_yardsticks_agree(kernel, clip):
    b, h, w = 2, 70, 80
    args, kw, library = prop_step_bwd_case(torch.Generator().manual_seed(4), "cpu",
                                           b, h, w, kernel, clip)
    again, kw2, _ = prop_step_bwd_case(torch.Generator().manual_seed(4), "cpu",
                                       b, h, w, kernel, clip)
    assert all(torch.equal(u, v) for u, v in zip(args, again))
    assert {k: v for k, v in kw.items() if k != "out"} == dict(
        kernel=kernel, preserve=True, clip=clip) == {k: v for k, v in kw2.items()
                                                     if k != "out"}
    g, pred, aff, conf, dep = args
    assert aff.shape == (b, kernel * kernel, h, w)
    assert bool((pred[:, :64, :64] == 0).all()) == clip
    if clip:   # the saved output: the forward's
        assert torch.equal(kw["out"], prop_step_plain(pred, aff, conf, dep, kernel=kernel,
                                                      preserve=True, clip=True))
        assert bool((kw["out"] == 0).any())
    want = prop_step_bwd_plain(*args, **kw)
    for got, ref in zip(library(), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * ref.abs().max().item())
    # the wrapper's CPU path takes the case's arguments
    assert all(torch.equal(u, v) for u, v in zip(prop_step_bwd(*args, **kw), want))

    fargs, fkw, flib = prop_step_case(torch.Generator().manual_seed(4), "cpu",
                                      b, h, w, kernel)
    fagain, _, _ = prop_step_case(torch.Generator().manual_seed(4), "cpu", b, h, w, kernel)
    assert all(torch.equal(u, v) for u, v in zip(fargs, fagain))
    assert fkw == dict(kernel=kernel, preserve=True, clip=False)
    ref = prop_step(*fargs, **fkw)
    np.testing.assert_allclose(flib().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("kernel,radius,off_std", [(3, None, 1.5), (3, 4, 12.0),
                                                   (5, 4, 1.5)])
def test_deform_case_is_seeded_and_its_yardstick_agrees(kernel, radius, off_std):
    b, h, w = 2, 30, 41
    args, kw, library = deform_prop_case(torch.Generator().manual_seed(6), "cpu", b,
                                         h, w, kernel, radius, off_std)
    again, _, _ = deform_prop_case(torch.Generator().manual_seed(6), "cpu", b, h, w,
                                   kernel, radius, off_std)
    assert all(torch.equal(u, v) for u, v in zip(args, again))
    assert kw == dict(kernel=kernel, radius=radius, preserve=True, clip=False)
    pred, off, aff, conf, dep = args
    assert off.shape == (b, 2 * kernel * kernel, h, w)
    if radius is None:
        assert off.abs().max() > STAGE_RADIUS   # eval: past the staged region
    else:
        assert off.abs().max() <= radius
    ref = deform_prop_fwd_plain(*args, **{k: v for k, v in kw.items() if k != "radius"})
    assert torch.equal(deform_prop(*args, **kw), ref)
    # grid_sample finds its taps through normalised coordinates: f32 rounding
    np.testing.assert_allclose(library().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4 * ref.abs().max().item())


def test_clipped_step_saves_its_output_for_the_backward():
    (g, pred, aff, conf, dep), kw, _ = prop_step_bwd_case(
        torch.Generator().manual_seed(8), "cpu", 1, 70, 80, 3, True)
    kw.pop("out")
    leaves = [t.clone().requires_grad_() for t in (pred, aff, conf)]
    out = prop_step(leaves[0], leaves[1], leaves[2], dep, **kw)
    assert torch.equal(out.grad_fn.saved_tensors[-1], out)   # the output, kept
    out.backward(g)
    want = prop_step_bwd_plain(g, pred, aff, conf, dep, **kw)
    for leaf, ref in zip(leaves, (want[0], want[1], want[2])):
        assert torch.equal(leaf.grad, ref)


TINY = dict(GRU_hidden_dim=16, GRU_input_dim=16, prop_time=3, compile_cache=False)


def test_predictor_without_weights_raises():
    with pytest.raises(ValueError, match="need `state_dict`"):
        Predictor(Config(**TINY), device="cpu")


def test_predictor_serves_the_weights_it_is_given():
    cfg = Config(**TINY)
    model = randomize_(get_model(cfg, device="cpu"), torch.Generator().manual_seed(3))
    predictor = Predictor(cfg, state_dict=model.state_dict(), device="cpu")
    rng = np.random.default_rng(4)
    rgbs = [rng.integers(0, 256, (30, 41, 3), dtype=np.uint8) for _ in range(2)]
    deps = [((rng.random((30, 41)) > 0.9) * rng.uniform(0.5, 5.0, (30, 41))
             ).astype(np.float32) for _ in range(2)]
    outs = predictor.predict_batch(rgbs, deps)
    sample, sizes = predictor.make_sample(rgbs, deps)
    with torch.inference_mode():
        ref = model(sample, need_inter=False)["pred"][:, 0].numpy()
    for i, (h, w) in enumerate(sizes):
        np.testing.assert_array_equal(outs[i], ref[i, :h, :w])
