"""K10b's redesign on the CPU, before and beside the card
(``csrc/deform_colgather.cu``, its wrapper in
``nlspn_eccv20_tpu_torch/devtools/exp_deform3.py``):

- its arithmetic, the tent's two rows u0 = floor(ty) and u0 + 1 only, each
  where it lies in the window (``deform_colgather_two_rows``), equals the
  plain version's walk over the whole window bit for bit, signs of zero
  included, at R = 0, 1 and 4, on offsets that are integers, one ulp below
  integers, at the window's edges and beyond it (up to 1e9), and on
  columns past the image border;
- its pixel-to-thread map (``colgather_map``) covers every pixel once, at
  NYU's 304 columns, KITTI's 1216 and an odd width;
- the seeded input case ``deform_colgather_case`` and ``profile_kernels``'
  K10b cases.
"""

import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu_torch.devtools import exp_deform3 as e3
from nlspn_eccv20_tpu_torch.tools import profile_kernels

B, H, W = 2, 11, 21


def _offsets(kind, radius, rng):
    shape = (B, 18, H, W)
    if kind == "integers":
        o = rng.integers(-radius - 3, radius + 4, shape).astype(np.float32)
    elif kind == "ulp_below_integers":
        o = np.nextafter(rng.integers(-radius - 3, radius + 4, shape).astype(np.float32),
                         np.float32(-np.inf))
    elif kind == "window_edges_and_beyond":
        r = float(radius)
        o = rng.choice(np.array([-r - 2.5, -r - 2, -r - 1.5, -r - 1, -r - 0.5, -r, r, r + 0.5,
                                 r + 1, r + 1.5, r + 2, r + 2.5, 1e9, -1e9, 0.25], np.float32),
                       shape)
    elif kind == "columns_past_the_border":
        o = (rng.standard_normal(shape) * (W + 5)).astype(np.float32)
    else:
        o = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(o))


@pytest.mark.parametrize("kind", ["integers", "ulp_below_integers", "window_edges_and_beyond",
                                  "columns_past_the_border", "normal"])
@pytest.mark.parametrize("radius", [0, 1, 4])
def test_two_rows_equal_the_plain_window_walk_bit_for_bit(radius, kind):
    rng = np.random.default_rng(17 * radius + len(kind))
    feat = torch.from_numpy(rng.standard_normal((B, H, W)).astype(np.float32))
    aff = torch.from_numpy((rng.standard_normal((B, 9, H, W)) * 0.11).astype(np.float32))
    off = _offsets(kind, radius, rng)
    got = e3.deform_colgather_two_rows(feat, off, aff, radius)
    want = e3.deform_colgather_plain(feat, off, aff, radius)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_two_rows_equal_the_plain_walk_on_the_experiments_inputs():
    (feat, off, aff, radius), _ = e3.deform_colgather_case(torch.Generator().manual_seed(4),
                                                           "cpu", 2, 23, 37)
    assert torch.equal(e3.deform_colgather_two_rows(feat, off, aff, radius),
                       e3.deform_colgather_plain(feat, off, aff, radius))


@pytest.mark.parametrize("h,w", [(228, 304), (240, 1216), (19, 75)])
def test_pixel_to_thread_map_covers_every_pixel_once(h, w):
    hits = np.zeros((h, w), np.int32)
    per_thread = []
    for pixels in e3.colgather_map(h, w).values():
        per_thread.append(len(pixels))
        for y, x in pixels:
            hits[y, x] += 1
        # a thread's pixels are neighbours along one row, 4-aligned
        if pixels:
            assert len({y for y, _ in pixels}) == 1
            assert pixels[0][1] % e3.COLGATHER_PX == 0
            assert [x for _, x in pixels] == list(range(pixels[0][1],
                                                        pixels[0][1] + len(pixels)))
    assert np.all(hits == 1)
    assert max(per_thread) == e3.COLGATHER_PX
    th, tw = e3.COLGATHER_TILE
    assert th * tw == e3.COLGATHER_THREADS * e3.COLGATHER_PX


def test_case_is_seeded_and_its_library_is_the_exact_gather():
    gen = lambda: torch.Generator().manual_seed(3)
    (feat, off, aff, radius), library = e3.deform_colgather_case(gen(), "cpu", 2, 13, 17)
    (feat2, off2, aff2, _), _ = e3.deform_colgather_case(gen(), "cpu", 2, 13, 17)
    assert feat.shape == (2, 13, 17) and off.shape == (2, 18, 13, 17)
    assert aff.shape == (2, 9, 13, 17) and radius == e3.RADIUS
    assert torch.equal(feat, feat2) and torch.equal(off, off2) and torch.equal(aff, aff2)
    assert float(off.abs().max()) <= 4.0
    ref = e3.deform_colgather_plain(feat, off, aff, radius)
    assert float((library() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_profile_kernels_times_k10b_at_nyu_and_kitti():
    cases = [c for c in profile_kernels.CASES if c[0] == "K10b"]
    assert cases == [("K10b", 12, 228, 304, {}), ("K10b", 1, 240, 1216, {})]
    assert profile_kernels.SOURCES["K10b"] == ["deform_colgather"]
