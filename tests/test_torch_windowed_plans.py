"""K10a's redesign on the CPU, before and beside the card
(``csrc/deform_windowed.cu``, its wrapper in
``nlspn_eccv20_tpu_torch/devtools/exp_deform_prop_kernel.py``):

- its arithmetic, the tent's two rows u0 = floor(oy), u0 + 1 and two
  columns v0 = floor(ox), v0 + 1 only, each where it lies in the window
  (``deform_windowed_two_taps``), equals the plain version's walk over the
  whole window (``propagate_deformable_windowed_planar``) bit for bit,
  signs of zero included, at R = 0, 1, 4 and 8 and K = 3 and 5, on offsets
  that are integers, one ulp below integers, at and past the window's
  edges (+-(R + 0.5 ... 2.5), +-1e9) and normal, and on the experiment's
  own inputs;
- its pixel-to-thread map (``windowed_map``) covers every pixel once, at
  NYU's 304 columns, KITTI's 1216 and an odd width;
- the seeded input case ``deform_windowed_case`` and ``profile_kernels``'
  K10a cases.
"""

import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu_torch.devtools import exp_deform3 as e3
from nlspn_eccv20_tpu_torch.devtools import exp_deform_prop_kernel as e1
from nlspn_eccv20_tpu_torch.ops.propagate import propagate_deformable_windowed_planar
from nlspn_eccv20_tpu_torch.tools import profile_kernels

B, H, W = 2, 11, 21


def _offsets(kind, shape, radius, rng):
    if kind == "integers":
        return rng.integers(-radius - 3, radius + 4, shape).astype(np.float32)
    if kind == "ulp_below_integers":
        return np.nextafter(rng.integers(-radius - 3, radius + 4, shape).astype(np.float32),
                            np.float32(-np.inf))
    if kind == "window_edges_and_beyond":
        r = float(radius)
        edges = [s * (r + d) for s in (-1, 1) for d in (0, 0.5, 1, 1.5, 2, 2.5)]
        return rng.choice(np.array(edges + [1e9, -1e9, 0.25], np.float32), shape)
    return (rng.standard_normal(shape) * 1.5 * max(radius, 1)).astype(np.float32)


def _assert_same_bits(got, want):
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("kind", ["integers", "ulp_below_integers", "window_edges_and_beyond",
                                  "normal"])
@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("radius", [0, 1, 4, 8])
def test_two_taps_equal_the_plain_window_walk_bit_for_bit(radius, kernel, kind):
    rng = np.random.default_rng(100 * radius + 10 * kernel + len(kind))
    k2 = kernel * kernel
    feat = torch.from_numpy(rng.standard_normal((B, H, W)).astype(np.float32))
    aff = torch.from_numpy((rng.standard_normal((B, k2, H, W)) * 0.11).astype(np.float32))
    off = torch.from_numpy(_offsets(kind, (B, 2 * k2, H, W), radius, rng))
    _assert_same_bits(e1.deform_windowed_two_taps(feat, off, aff, kernel, radius),
                      propagate_deformable_windowed_planar(feat, off, aff, kernel, radius))


def test_two_taps_equal_the_plain_walk_on_the_experiments_inputs():
    feat, off, aff = e3.experiment_inputs(2, 23, 37, "cpu", seed=5)
    f = feat[:, 0]
    _assert_same_bits(e1.deform_windowed_two_taps(f, off, aff, 3, e3.RADIUS),
                      propagate_deformable_windowed_planar(f, off, aff, 3, e3.RADIUS))


@pytest.mark.parametrize("h,w", [(228, 304), (240, 1216), (19, 75)])
def test_pixel_to_thread_map_covers_every_pixel_once(h, w):
    hits = np.zeros((h, w), np.int32)
    per_thread = []
    th, tw = e1.WINDOWED_TILE
    warp = tw // e1.WINDOWED_PX
    tmap = e1.windowed_map(h, w)
    for (by, bx, t), pixels in tmap.items():
        per_thread.append(len(pixels))
        for y, x in pixels:
            hits[y, x] += 1
        # a thread's pixels lie on one row, a warp's width apart
        if pixels:
            assert len({y for y, _ in pixels}) == 1
            assert [x for _, x in pixels] == list(range(pixels[0][1],
                                                        pixels[0][1] + warp * len(pixels),
                                                        warp))
        # the 32 threads of a warp take 32 neighbouring columns of one row
        if t % 32 == 0:
            for i in range(e1.WINDOWED_PX):
                lane = [tmap[(by, bx, t + j)] for j in range(32)]
                cols = [px[i] for px in lane if len(px) > i]
                if cols:
                    assert len({y for y, _ in cols}) == 1
                    assert [x for _, x in cols] == list(range(cols[0][1],
                                                              cols[0][1] + len(cols)))
    assert np.all(hits == 1)
    assert max(per_thread) == e1.WINDOWED_PX
    assert th * tw == e1.WINDOWED_THREADS * e1.WINDOWED_PX
    assert warp == 32


@pytest.mark.parametrize("kernel", [3, 5])
def test_case_is_seeded_and_its_library_is_the_exact_gather(kernel):
    gen = lambda: torch.Generator().manual_seed(3)
    (feat, off, aff, k, radius), library = e1.deform_windowed_case(gen(), "cpu", 2, 13, 17,
                                                                   kernel)
    (feat2, off2, aff2, _, _), _ = e1.deform_windowed_case(gen(), "cpu", 2, 13, 17, kernel)
    k2 = kernel * kernel
    assert feat.shape == (2, 13, 17) and off.shape == (2, 2 * k2, 13, 17)
    assert aff.shape == (2, k2, 13, 17) and (k, radius) == (kernel, e3.RADIUS)
    assert torch.equal(feat, feat2) and torch.equal(off, off2) and torch.equal(aff, aff2)
    assert float(off.abs().max()) <= 4.0
    ref = propagate_deformable_windowed_planar(feat, off, aff, kernel, radius)
    assert float((library() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_profile_kernels_times_k10a_at_nyu_kitti_and_5x5():
    cases = [c for c in profile_kernels.CASES if c[0] == "K10a"]
    assert cases == [("K10a", 12, 228, 304, {}), ("K10a", 1, 240, 1216, {}),
                     ("K10a", 1, 228, 304, {"kernel": 5})]
    assert profile_kernels.SOURCES["K10a"] == ["deform_windowed"]
