"""K2-bf16's redesign on the bf16 tensor cores (``csrc/dec_aff_tail_bf16.cu``),
held on the CPU: its launch plan's Python mirror (``tail_plan_bf16``, which
``chip_smoke.py`` holds against the plan the built kernel reports), its M
rows (the tile and its halo), the weights packed as the kernel's B operands
(``quad_mma.pack``, ``tail_pack_w2``), and its arithmetic tile by tile
(``decode_aff_tail_bf16_tiles``) against the bf16 plain version
``decode_aff_tail_plain_bf16_y1`` at the model's widths (C = 256, K = 8
and 24) on small grids: within one bf16 ulp of max |plain| and at most
1e-2 of the outputs and of y1 not bit-equal, the bar phase 14 of the smoke
holds the kernel to. A rounding after each shifted product passes the ulp
bound but not that share. The kernel itself runs only on the card.
"""

import pytest
import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import quad_mma
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    BF16_CHUNK, BF16_TILE, CARD_SMS, SPLITS, _bf16, decode_aff_tail_bf16_tiles,
    decode_aff_tail_case, decode_aff_tail_plain_bf16_y1, tail_chunks_bf16, tail_m_rows_bf16,
    tail_pack_w2, tail_plan_bf16, tail_smem_bf16)

ULP = 2.0 ** -7
SHARE = 1e-2
CARD_SMEM = 232448     # bytes of shared memory a block can have on the H100


def _case(b, hg, wg, k, c, seed=0):
    (x, w1, b1, w2, b2), _ = decode_aff_tail_case(torch.Generator().manual_seed(seed), "cpu",
                                                  b, hg, wg, k, c)
    return x.to(torch.bfloat16), w1, b1, w2, b2


def _hold(got, want):
    rel = ((got - want).abs().max() / want.abs().max()).item()
    share = (got != want).float().mean().item()
    assert rel <= ULP and share <= SHARE, (rel, share)


# (b, hg, wg, K, C, split): the model's widths with the plan's S (1 here),
# every cluster size the card's plan picks (2, 4, 8: the ranks' partials
# added in rank order), ragged grids and C not a multiple of 32
CASES = [(1, 9, 17, 8, 256, None), (1, 9, 17, 24, 256, None), (2, 11, 19, 8, 256, 2),
         (1, 9, 17, 24, 256, 4), (1, 5, 7, 8, 256, 8), (1, 13, 33, 8, 40, None),
         (1, 9, 17, 8, 30, None)]


@pytest.mark.parametrize("b,hg,wg,k,c,split", CASES)
def test_arithmetic_matches_the_plain_version(b, hg, wg, k, c, split):
    args = _case(b, hg, wg, k, c)
    out, y1 = decode_aff_tail_bf16_tiles(*args, split=split)
    want, want_y1 = decode_aff_tail_plain_bf16_y1(*args)
    assert out.shape == want.shape and y1.shape == want_y1.shape
    _hold(out, want)
    _hold(y1, want_y1)


# the taps each shift (sy, sx) of a base pixel feeds (quad_mma.cuh's table)
SHIFT_TAPS = {(0, 0): (4, 5, 7, 8), (0, 1): (3, 6), (1, 0): (1, 2), (1, 1): (0,)}


def _per_shift_rounded(x, w1, b1, w2, b2):
    """Both transposed convs with each shift's product rounded to bf16
    before the four are added: the TPU kernel rounds once, after the sum."""
    def deconv(a, w, bias):
        total = 0.0
        for taps in SHIFT_TAPS.values():
            mask = torch.zeros(9)
            mask[list(taps)] = 1.0
            total = total + _bf16(F.conv_transpose2d(a, _bf16(w) * mask.view(1, 1, 3, 3),
                                                     None, 2, 1, 1))
        return total + _bf16(bias)[None, :, None, None]

    y1 = _bf16(F.relu(deconv(_bf16(x).permute(0, 3, 1, 2), w1, b1)))
    return _bf16(deconv(y1, w2, b2)), y1


@pytest.mark.parametrize("k", [8, 24])
def test_a_rounding_per_shift_fails_the_share_bar(k):
    """One ulp of max |plain| does not tell the TPU kernel's rounding points
    from a rounding per shifted product; the share of outputs not
    bit-equal does (about half of them)."""
    args = _case(1, 9, 17, k, 256)
    bad, _ = _per_shift_rounded(*args)
    want, _ = decode_aff_tail_plain_bf16_y1(*args)
    assert ((bad - want).abs().max() / want.abs().max()).item() <= ULP
    assert (bad != want).float().mean().item() > 20 * SHARE


@pytest.mark.parametrize("c", [256, 40, 30])
def test_packed_w1_reads_back_as_the_taps(c):
    """Each product's B, read through the descriptor's layout, is W at the
    taps quad_mma.cuh assigns its columns, zero past C."""
    w = torch.randn(c, 16, 3, 3, generator=torch.Generator().manual_seed(1))
    ksteps = 2 * -(-c // BF16_CHUNK)
    wp = quad_mma.pack(w, ksteps)
    wr = _bf16(w).reshape(c, 16, 9)
    for ks in range(ksteps):
        full = quad_mma.b_operand(wp[ks], 0, quad_mma.NCOL)     # (16 k, 144 n)
        for blk, tap in enumerate(quad_mma.QTAPS):
            for kk in range(16):
                ch = 16 * ks + kk
                want = wr[ch, :, tap] if ch < c else torch.zeros(16)
                assert torch.equal(full[kk, 16 * blk:16 * blk + 16], want)


@pytest.mark.parametrize("k", [8, 24])
def test_packed_w2_reads_back_as_the_taps(k):
    """deconv2's B of shift (sy, sx), column n = 2K dy + 2k + dx: W2[m][k]
    at the tap that shift feeds into phase (dy, dx), else zero."""
    w2 = torch.randn(16, k, 3, 3, generator=torch.Generator().manual_seed(2))
    wp = tail_pack_w2(w2)
    w = _bf16(w2).reshape(16, k, 9)
    phase_tap = {(0, 0): {(0, 0): 4, (0, 1): 5, (1, 0): 7, (1, 1): 8},
                 (0, 1): {(0, 1): 3, (1, 1): 6}, (1, 0): {(1, 0): 1, (1, 1): 2},
                 (1, 1): {(1, 1): 0}}
    for s, shift in enumerate(quad_mma.SHIFTS):
        bop = quad_mma.b_operand(wp[s], 0, 4 * k)                # (16 m, 4K n)
        for n in range(4 * k):
            dy, kk, dx = n // (2 * k), (n % (2 * k)) // 2, n % 2
            tap = phase_tap[shift].get((dy, dx))
            assert torch.equal(bop[:, n], w[:, kk, tap] if tap is not None else torch.zeros(16))


def test_m_rows_cover_the_tile_and_its_halo_once():
    """deconv1's 192 M rows: the 8x16 tile's 128 base pixels, then row TH at
    columns 0..TW and column TW at rows 0..TH-1 (the halo deconv2 reads),
    each once; the rest read the zero row."""
    th, tw = BF16_TILE
    rows = tail_m_rows_bf16()
    assert len(rows) == 3 * 64
    got = [r for r in rows if r is not None]
    want = ([(i, j) for i in range(th) for j in range(tw)] + [(th, j) for j in range(tw + 1)]
            + [(i, tw) for i in range(th)])
    assert got == want and len(set(got)) == len(got) == 153


@pytest.mark.parametrize("b,hg,wg,c,split", [
    (1, 64, 80, 256, 2), (2, 64, 80, 256, 1), (4, 64, 80, 256, 1), (12, 58, 76, 256, 1),
    (1, 60, 304, 256, 1), (1, 57, 75, 256, 2), (1, 29, 38, 256, 8), (1, 40, 64, 256, 4),
    (1, 64, 80, 40, 2), (1, 58, 76, 30, 1)])
def test_plan_fills_one_wave_and_covers_the_grid(b, hg, wg, c, split):
    """The tiles cover the base grid; S is the largest cluster size whose
    CTAs fit one wave of one CTA an SM, at most one a chunk; the ranks'
    chunks partition the channels in order; the shared memory fits."""
    for k in (8, 24):
        p = tail_plan_bf16(b, hg, wg, c, k, CARD_SMS)
        rows, cols = p["tiles_y"], p["tiles_x"]
        assert (rows - 1) * BF16_TILE[0] < hg <= rows * BF16_TILE[0]
        assert (cols - 1) * BF16_TILE[1] < wg <= cols * BF16_TILE[1]
        s = p["split"]
        assert s == split and s in SPLITS
        ctas = b * rows * cols * s
        assert ctas <= CARD_SMS or s == 1
        assert s == 8 or 2 * ctas > CARD_SMS or 2 * s > p["chunks"]
        ranges = tail_chunks_bf16(c, s)
        assert ranges[0][0] == 0 and ranges[-1][1] == p["chunks"] == -(-c // BF16_CHUNK)
        assert all(a < z for a, z in ranges)
        assert all(z == a2 for (_, z), (a2, _) in zip(ranges, ranges[1:]))
        assert p["smem"] == tail_smem_bf16(k) <= CARD_SMEM - 1024
