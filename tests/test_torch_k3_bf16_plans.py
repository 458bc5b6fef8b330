"""K3-bf16's redesign on the bf16 tensor cores (``csrc/dep_encode_front_bf16.cu``),
held on the CPU: its launch plan's Python mirror (``front_plan_bf16``,
which ``chip_smoke.py`` holds against the plan the built kernel reports),
w1 packed as the kernel's B operands (``front_pack_w1``), and its
arithmetic tile by tile (``dep_encode_front_bf16_tiles``: p0 with its halo
and conv1's zero padding, nine f32 tap products a tile, one rounding)
against the bf16 plain version ``dep_encode_front_plain_bf16`` at the
model's width C1 = 256 and at 96, 30 and 300 (two passes), on small planes:
within one bf16 ulp of max |plain| and at most 1e-2 of the outputs not
bit-equal, the bars phase 14 of the smoke holds the kernel to; and against
the JAX TPU kernel (``_fwd_pallas`` at bf16 in interpret mode) within one
ulp. A rounding of each tap's product passes the ulp bound but not that
share. The kernel itself runs only on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nlspn_eccv20_tpu.ops.pallas.dep_encode_front as jax_def
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    CARD_SMS, FRONT_TILE, MID_CHANNELS, _bf16, dep_encode_front_bf16_tiles,
    dep_encode_front_case, dep_encode_front_plain_bf16, front_b_operand, front_pack_w1,
    front_plan_bf16)
from nlspn_eccv20_tpu_torch.utils.weights import _conv_w

ULP = 2.0 ** -7
SHARE = 1e-2
CARD_SMEM = 232448     # bytes of shared memory a block can have on the H100


def _case(b, h, w, c, seed=0):
    (plane, w0, b0, w1, b1), _ = dep_encode_front_case(torch.Generator().manual_seed(seed),
                                                       "cpu", b, h, w, c)
    return plane.to(torch.bfloat16), w0, b0, w1, b1


def _scores(got, want):
    g, r = got.float(), want.float()
    return ((g - r).abs().max() / r.abs().max()).item(), (g != r).float().mean().item()


def _half(n):
    return (n + 1) // 2


PLAN_SHAPES = [(1, 228, 304), (2, 228, 304), (12, 228, 304), (1, 256, 320), (4, 256, 320),
               (1, 230, 306), (12, 230, 306), (1, 240, 1216), (1, 9, 11), (2, 37, 53)]


@pytest.mark.parametrize("c", [256, 96, 30])
@pytest.mark.parametrize("bhw", PLAN_SHAPES)
def test_plan_covers_every_output_once_and_fits(bhw, c):
    """The 4x16 tiles cover the Ho x Wo outputs; the persistent walk
    (CTA c, team t: tiles t grid_x + c, then every 2 grid_x on) takes each
    tile once; the passes of 2 nw channels cover C1 with the least nw; one
    CTA an SM, fewer where the tiles are fewer; the shared memory (the
    weights, each team's p0, plane and staging tiles) fits a block;
    the accumulators (nw / 2), two A fragments and the plane prefetch fit
    the 128 registers of a 512-thread CTA."""
    b, h, w = bhw
    p = front_plan_bf16(b, h, w, c)
    ho, wo = _half(_half(h)), _half(_half(w))
    th, tw = FRONT_TILE
    assert (p["tiles_y"] - 1) * th < ho <= p["tiles_y"] * th
    assert (p["tiles_x"] - 1) * tw < wo <= p["tiles_x"] * tw
    nw, passes = p["nw"], p["passes"]
    assert nw in (16, 32, 64, 128) and (passes - 1) * 2 * nw < c <= passes * 2 * nw
    assert nw == 128 or 2 * nw >= c
    assert nw == 16 or 2 * (nw // 2) < c      # no smaller width would do
    tiles = b * p["tiles_y"] * p["tiles_x"]
    assert p["grid_x"] == min(tiles, CARD_SMS // passes) and p["grid_x"] * passes <= CARD_SMS
    seen = []
    for cta in range(p["grid_x"]):
        for team in range(2):
            seen += list(range(team * p["grid_x"] + cta, tiles, 2 * p["grid_x"]))
    assert sorted(seen) == list(range(tiles))
    per, pixels = p["tiles_y"] * p["tiles_x"], set()
    for t in range(tiles):
        bb, r = divmod(t, per)
        oy0, ox0 = r // p["tiles_x"] * th, r % p["tiles_x"] * tw
        pixels |= {(bb, oy0 + i, ox0 + j) for i in range(th) for j in range(tw)}
    assert len(pixels) == tiles * th * tw
    assert {(bb, y, x) for bb in range(b) for y in range(ho) for x in range(wo)} <= pixels
    assert p["smem"] <= CARD_SMEM and p["threads"] == 512
    assert nw // 2 + 8 + 5 + 24 <= 65536 // p["threads"]


@pytest.mark.parametrize("c", [256, 96, 30, 300])
def test_packed_w1_reads_back_as_the_taps(c):
    """Each warpgroup's B of each tap, read through the descriptor's
    layout, is w1 rounded to bf16 at that tap, channel p 2nw + n of pass p,
    zero past C1."""
    w1 = torch.randn(c, MID_CHANNELS, 3, 3, generator=torch.Generator().manual_seed(1))
    p = front_plan_bf16(1, 64, 64, c)
    nw, passes = p["nw"], p["passes"]
    wp = front_pack_w1(w1, nw, passes)
    assert wp.shape == (passes, 9, 32 * nw) and wp.dtype == torch.bfloat16
    wr = _bf16(w1).reshape(c, MID_CHANNELS, 9)
    for ps in range(passes):
        for tap in range(9):
            for wg in range(2):
                bop = front_b_operand(wp[ps, tap], wg * nw, nw)          # (16 k, nw n)
                for n in range(nw):
                    ch = ps * 2 * nw + wg * nw + n
                    want = wr[ch, :, tap] if ch < c else torch.zeros(MID_CHANNELS)
                    assert torch.equal(bop[:, n], want)


# (b, h, w, C1): the model's width on ragged planes (the last tiles past
# Ho and Wo), an odd plane, C1 = 96 and 30 (nw 64 and 16; 30 not a
# multiple of 8), 300 (two passes)
CASES = [(1, 36, 70, 256), (2, 30, 66, 256), (1, 33, 35, 96), (1, 17, 130, 256),
         (1, 29, 37, 30), (1, 21, 45, 300)]


@pytest.mark.parametrize("b,h,w,c", CASES)
def test_arithmetic_matches_the_plain_version(b, h, w, c):
    args = _case(b, h, w, c)
    got = dep_encode_front_bf16_tiles(*args)
    want = dep_encode_front_plain_bf16(*args)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    rel, share = _scores(got, want)
    assert rel <= ULP and share <= SHARE, (rel, share)


def _per_tap_rounded(xplane, w0, b0, w1, b1):
    """The front with each of conv1's nine tap products rounded to bf16
    before they are added: the TPU kernel rounds once, after the sum."""
    p0 = _bf16(F.relu(F.conv2d(_bf16(xplane.float())[:, None], _bf16(w0), _bf16(b0), 2, 1)))
    total = 0.0
    for tap in range(9):
        mask = torch.zeros(9)
        mask[tap] = 1.0
        total = total + _bf16(F.conv2d(p0, _bf16(w1) * mask.view(1, 1, 3, 3), None, 2, 1))
    out = F.relu(total + _bf16(b1)[None, :, None, None])
    return out.permute(0, 2, 3, 1).to(torch.bfloat16)


@pytest.mark.parametrize("b,h,w,c", CASES[:2])
def test_a_rounding_per_tap_fails_the_share_bar(b, h, w, c):
    """One ulp of max |plain| does not tell the TPU kernel's one rounding of
    conv1's f32 sum from a rounding of each tap's product; the share of
    outputs not bit-equal does (about a fifth of them)."""
    args = _case(b, h, w, c)
    rel, share = _scores(_per_tap_rounded(*args), dep_encode_front_plain_bf16(*args))
    assert rel <= ULP
    assert share > 10 * SHARE, share


def _jax_inputs(b, h, w, c1, seed=21):
    rng = np.random.default_rng(seed)
    x = np.array(jnp.asarray(rng.random((b, h, w)), jnp.bfloat16).astype(jnp.float32))
    return (x, (rng.standard_normal((3, 3, 1, MID_CHANNELS)) * 0.3).astype(np.float32),
            (rng.standard_normal(MID_CHANNELS) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, MID_CHANNELS, c1)) * 0.1).astype(np.float32),
            (rng.standard_normal(c1) * 0.1).astype(np.float32))


@pytest.mark.parametrize("b,h,w,c", [(2, 16, 44, 96), (1, 20, 72, 256)])
def test_arithmetic_matches_the_tpu_kernel(monkeypatch, b, h, w, c):
    """The tile mirror within one bf16 ulp of the JAX TPU kernel at bf16 in
    interpret mode (the TPU kernel takes H and W in multiples of 4)."""
    monkeypatch.setattr(jax_def, "FORCE_PALLAS_INTERPRET", True)
    x, w0, b0, w1, b1 = _jax_inputs(b, h, w, c)
    ref = jax_def._fwd_pallas(*map(jnp.asarray, (x, w0, b0, w1, b1)), jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    args = (torch.from_numpy(x).bfloat16(), _conv_w(w0), torch.from_numpy(b0), _conv_w(w1),
            torch.from_numpy(b1))
    got = dep_encode_front_bf16_tiles(*args)
    rel, share = _scores(got, torch.from_numpy(np.asarray(ref.astype(jnp.float32))))
    assert rel <= ULP and share <= SHARE, (rel, share)
