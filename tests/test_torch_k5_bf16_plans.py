"""K5-bf16's dP0 pass on the bf16 tensor cores (``dp0_mma_kernel`` in
``csrc/dep_encode_front_bwd.cu``), held on the CPU: its launch plan's
Python mirror (``front_bwd_plan_bf16``, which ``chip_smoke.py`` holds
against the plan the built kernel reports) and its arithmetic tile by tile
(``dep_encode_front_bwd_bf16_tiles``: gm staged with its halo, each
split's f32 sums over its chunks on the packed w1, the splits added in
order, one bf16 rounding of dP0) against the bf16 plain version
``dep_encode_front_bwd_plain_bf16`` at the model's width C1 = 256 and at
96 and 30, on small planes: the plane's gradient within one bf16 ulp of max
|plain| and at most 1e-3 of it not bit-equal, each weight and bias
gradient within 5e-4, the bars phase 15 of the smoke holds the kernel to.
The kernel itself runs only on the card.
"""

import pytest
import torch

from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    tail_bwd_plan_bf16, wgrad_s2_slices, wgrad_s2_smem)
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    CARD_SMS, DP0_CHUNK, DP0_TILE, dep_encode_front_bwd_bf16_tiles, dep_encode_front_bwd_case,
    dep_encode_front_bwd_plain_bf16, front_bwd_plan_bf16)

ULP = 2.0 ** -7
CARD_SMEM = 232448     # bytes of shared memory a block can have on the H100


# (b, h, w, C1, split): the plan's split (8 at these small planes, as at
# b=1 of 228x304), one split, odd planes and widths
CASES = [(1, 36, 70, 256, None), (2, 30, 66, 256, 3), (1, 33, 35, 96, None),
         (1, 17, 130, 256, 1), (1, 29, 37, 30, None)]


@pytest.mark.parametrize("b,h,w,c,split", CASES)
def test_dp0_arithmetic_matches_the_plain_version(b, h, w, c, split):
    args, _ = dep_encode_front_bwd_case(torch.Generator().manual_seed(0), "cpu", b, h, w, c,
                                        dtype=torch.bfloat16)
    got = dep_encode_front_bwd_bf16_tiles(*args, split=split)
    want = dep_encode_front_bwd_plain_bf16(*args)
    assert got[0].dtype == want[0].dtype == torch.bfloat16
    dx, ref = got[0].float(), want[0].float()
    assert ((dx - ref).abs().max() / ref.abs().max()).item() <= ULP
    assert (dx != ref).float().mean().item() <= 1e-3
    for g, r in zip(got[1:], want[1:]):
        assert g.shape == r.shape
        assert ((g - r).abs().max() / r.abs().max()).item() <= 5e-4


@pytest.mark.parametrize("b,h,w,c", [(12, 228, 304, 256), (1, 228, 304, 256), (2, 230, 306, 256),
                                     (1, 240, 1216, 256), (1, 228, 304, 96),
                                     (1, 228, 304, 30)])
def test_dp0_plan_covers_fills_and_fits(b, h, w, c):
    """The 8x16 tiles cover the base (gm) grid; the splits partition a
    tile's chunks in order, each non-empty, and fill two blocks an SM where
    the tiles do not (one split where they do); two blocks fit an SM; p0's
    pitch is W1 rounded up to even; the weight gradient's slices and its
    shared memory (now its bf16 form only) are K4-bf16's."""
    p = front_bwd_plan_bf16(b, h, w, c)
    h1, w1 = (h + 1) // 2, (w + 1) // 2
    ho, wo = (h1 + 1) // 2, (w1 + 1) // 2
    assert (p["tiles_y"] - 1) * DP0_TILE[0] < ho <= p["tiles_y"] * DP0_TILE[0]
    assert (p["tiles_x"] - 1) * DP0_TILE[1] < wo <= p["tiles_x"] * DP0_TILE[1]
    tiles, n, s = b * p["tiles_y"] * p["tiles_x"], p["chunks"], p["split"]
    assert n == -(-c // DP0_CHUNK) and 1 <= s <= n
    ranges = [(r * n // s, (r + 1) * n // s) for r in range(s)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n and all(a < z for a, z in ranges)
    assert s == n or tiles * s >= 2 * CARD_SMS
    assert s == 1 or tiles * (s - 1) < 2 * CARD_SMS
    assert 2 * (p["smem"] + 2048) <= CARD_SMEM
    assert p["p0_pitch"] % 2 == 0 and p["p0_pitch"] - w1 in (0, 1)
    assert p["slices"] == wgrad_s2_slices(b * ho * wo, c)
    assert tail_bwd_plan_bf16(b, ho, wo, c)["wg_smem"] == wgrad_s2_smem()
    assert 2 * (wgrad_s2_smem() + 1024) <= CARD_SMEM
