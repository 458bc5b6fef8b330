"""K9-bf16 and K9b-bf16, the op library's bf16 forms, held against the JAX
package's TPU kernels at ``dt = bfloat16``, on the CPU.

The port's bf16 plain versions (``small_conv3x3_plain_bf16``,
``small_conv3x3_bwd_plain_bf16``) repeat the TPU kernels' rounding: the
forward rounds each tap's f32 sum over the channels to bf16 before the nine
taps and the bias are summed (``_fwd_kernel``'s ``y9.astype(dt)``), the
backward rounds g and the weights and rounds dx once. The JAX side runs
``_fwd_pallas`` and ``_bwd_pallas`` on bf16 activations in interpret mode;
its runs are cached per shape, so each runs once a process. A bf16 ulp is
2^-7 of the largest |JAX| value (the bar for the largest difference); the
share of outputs that are not bit-equal is held apart. The last tests hold
the tile and slice plans of the CUDA kernels (``fwd_plan_bf16``,
``bwd_plan_bf16`` and K4-bf16's ``tail_bwd_plan_bf16``) on the CPU; the
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nlspn_eccv20_tpu.ops.pallas.small_conv3x3 as sc
from nlspn_eccv20_tpu_torch.ops.kernels import small_conv3x3 as port
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    tail_bwd_plan_bf16, wgrad_s2_segments, wgrad_s2_slices)
from nlspn_eccv20_tpu_torch.ops.kernels.small_conv3x3 import (
    BF16, SmallConv3x3Function, bwd_plan_bf16, fwd_plan_bf16, small_conv3x3_bf16,
    small_conv3x3_bf16_chunks_plain, small_conv3x3_bwd, small_conv3x3_bwd_bf16,
    small_conv3x3_bwd_plain_bf16, small_conv3x3_plain_bf16, small_conv3x3_planar)

ULP = 2.0 ** -7
# (B, H, W, Ca, Cb, K): an odd shape; the heads' stage 2 (Ca 192 = three
# 64-wide heads, Cb 64 = fe1) with K 10 and the offset heads' K 26
SHAPES = [(1, 7, 13, 24, 8, 5), (2, 10, 13, 192, 64, 10), (1, 9, 11, 192, 64, 26)]
IDS = ["odd", "heads-k10", "heads-k26"]


def _inputs(shape, seed=0):
    """NHWC bf16-valued activations, an HWIO f32 weight, an f32 bias and an
    f32 planar cotangent, from numpy."""
    b, h, w, ca, cb, k = shape
    rng = np.random.default_rng(seed)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    return (bf16(rng.standard_normal((b, h, w, ca))), bf16(rng.standard_normal((b, h, w, cb))),
            (rng.standard_normal((3, 3, ca + cb, k)) * (9 * (ca + cb)) ** -0.5).astype(np.float32),
            (rng.standard_normal(k) * 0.1).astype(np.float32),
            rng.standard_normal((b, k, h, w)).astype(np.float32))


def _port(xa, xb, w, b, g):
    """The same arrays in the port's layouts: NCHW bf16 activations, OIHW
    f32 weight."""
    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(BF16)

    return (nchw(xa), nchw(xb), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            torch.from_numpy(b), torch.from_numpy(g))


@functools.lru_cache(maxsize=None)
def _jax_runs(shape):
    """(forward, (dxa, dxb, dw, db)) of the TPU kernels in interpret mode at
    bf16, in the port's layouts, as float32 numpy arrays."""
    xa, xb, w, b, g = _inputs(shape)
    old = sc.FORCE_PALLAS_INTERPRET
    sc.FORCE_PALLAS_INTERPRET = True
    try:
        xaj, xbj = jnp.asarray(xa, jnp.bfloat16), jnp.asarray(xb, jnp.bfloat16)
        out = sc._fwd_pallas(xaj, xbj, jnp.asarray(w), jnp.asarray(b))
        dxa, dxb, dw, db = sc._bwd_pallas(xaj, xbj, jnp.asarray(w), jnp.asarray(b),
                                          jnp.asarray(g))
    finally:
        sc.FORCE_PALLAS_INTERPRET = old
    assert out.dtype == jnp.bfloat16 and dxa.dtype == jnp.bfloat16 and dw.dtype == jnp.float32

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    return f32(out), (f32(dxa).transpose(0, 3, 1, 2), f32(dxb).transpose(0, 3, 1, 2),
                      f32(dw).transpose(3, 2, 0, 1), f32(db))


def _scores(port_t, ref):
    """(largest |difference| / max |ref|, share of elements not bit-equal)."""
    p = port_t.detach().float().numpy()
    assert p.shape == ref.shape, (p.shape, ref.shape)
    return np.max(np.abs(p - ref)) / np.max(np.abs(ref)), float(np.mean(p != ref))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_matches_pallas_kernel(shape):
    """Within one bf16 ulp of the TPU kernel and bit-equal on at least 99%
    of the outputs (measured: bit-equal on all of them at these shapes)."""
    ref, _ = _jax_runs(shape)
    xa, xb, w, b, _ = _port(*_inputs(shape))
    n0 = small_conv3x3_bf16.launches
    out = small_conv3x3_planar(xa, xb, w, b)
    assert out.dtype == BF16 and out.shape == ref.shape
    err, share = _scores(out, ref)
    assert err <= ULP, f"relative error {err:.3e} > 2^-7"
    assert share <= 0.01, f"{share:.3e} of the outputs not bit-equal"
    assert small_conv3x3_bf16.launches == n0   # the CPU runs no kernel


@pytest.mark.parametrize("shape", SHAPES[1:], ids=IDS[1:])
def test_one_rounding_conv_fails_the_bit_share_bar(shape):
    """A bf16 conv that rounds its whole f32 sum once (what a plain bf16
    conv, and cuDNN's, computes) is within one ulp but not bit-equal on
    far more than 1% of the outputs at the heads' widths: the bit-share bar
    above tells it from the TPU kernel's per-tap rounding."""
    ref, _ = _jax_runs(shape)
    xa, xb, w, b, _ = _port(*_inputs(shape))
    once = F.conv2d(torch.cat([xa, xb], 1).float(), w.to(BF16).float(),
                    b.to(BF16).float(), padding=1).to(BF16)
    err, share = _scores(once, ref)
    assert err <= 2 * ULP
    assert share > 0.2, f"only {share:.3e} of a one-rounding conv's outputs differ"


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_matches_pallas_kernel(shape):
    """dx within one bf16 ulp and bit-equal on at least 99.9% of its
    elements; dW and db within 1e-4 of max |JAX| (f32 sums of exact
    products in another order)."""
    _, refs = _jax_runs(shape)
    xa, xb, w, b, g = _port(*_inputs(shape))
    outs = small_conv3x3_bwd(g, xa, xb, w)
    assert [t.dtype for t in outs] == [BF16, BF16, torch.float32, torch.float32]
    for name, got, ref in zip(("dxa", "dxb"), outs[:2], refs[:2]):
        err, share = _scores(got, ref)
        assert err <= ULP, f"{name}: relative error {err:.3e} > 2^-7"
        assert share <= 1e-3, f"{name}: {share:.3e} not bit-equal"
    for name, got, ref in zip(("dw", "db"), outs[2:], refs[2:]):
        err, _ = _scores(got, ref)
        assert err <= 1e-4, f"{name}: relative error {err:.3e} > 1e-4"


@pytest.mark.parametrize("wdtype", [torch.float32, BF16])
def test_dtype_contract_under_autograd(wdtype):
    """f32 or bf16 weights in, bf16 out; under autograd (the Function on
    bf16 CPU tensors) dxa and dxb come back bf16 and dW and db in the
    leaves' own dtypes, equal to the plain backward's f32 sums cast."""
    xa, xb, w, b, g = _port(*_inputs(SHAPES[0], seed=3))
    w, b = w.to(wdtype), b.to(wdtype)
    leaves = [t.clone().requires_grad_(True) for t in (xa, xb, w, b)]
    out = small_conv3x3_planar(*leaves)
    assert out.dtype == BF16
    assert torch.equal(out, small_conv3x3_plain_bf16(xa, xb, w, b))
    out.backward(g.to(BF16))
    want = small_conv3x3_bwd_plain_bf16(g, xa, xb, w)
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        assert torch.equal(leaf.grad, ref.to(leaf.dtype))
    # the Function itself, and the K9b-bf16 entry point, on CPU tensors
    assert torch.equal(SmallConv3x3Function.apply(xa, xb, w, b), out.detach())
    for got, ref in zip(small_conv3x3_bwd_bf16(g, xa, xb, w), want):
        assert torch.equal(got, ref)


def test_f32_xb_is_cast_and_bad_shapes_raise():
    """xb is cast to xa's dtype, as JAX casts it; shapes are checked as in
    f32."""
    xa, xb, w, b, _ = _port(*_inputs(SHAPES[0], seed=5))
    assert torch.equal(small_conv3x3_planar(xa, xb.float(), w, b),
                       small_conv3x3_planar(xa, xb, w, b))
    with pytest.raises(ValueError, match="K = 33"):
        small_conv3x3_planar(xa, xb, torch.zeros(33, xa.shape[1] + xb.shape[1], 3, 3),
                             torch.zeros(33))
    with pytest.raises(ValueError):
        small_conv3x3_planar(xa, xb[:, :, :3], w, b)


# ---- the CUDA kernels' plans, on the CPU ----

PLAN_SHAPES = [(12, 228, 304), (1, 256, 320), (4, 256, 320), (2, 57, 75), (1, 9, 11)]


@pytest.mark.parametrize("k", [1, 10, 26, 32])
@pytest.mark.parametrize("bhw", PLAN_SHAPES)
def test_forward_plan_covers_and_fits(bhw, k):
    """K9-bf16: its tiles cover every pixel once; a tile's staged rows
    (16-byte pieces) hold every column its nine taps read; the staged plane
    keeps a warp's four planes in distinct banks; three stages fit its
    blocks on an SM; the nine accumulators and a batch of A fragments fit
    the registers."""
    b, h, w = bhw
    p = fwd_plan_bf16(b, h, w, 192, 64, k)
    gx, gy, gz = p["grid"]
    th, tw = p["tile"]
    assert gz == b and (gx - 1) * tw < w <= gx * tw and (gy - 1) * th < h <= gy * th
    assert p["n"] >= k and p["n"] % 8 == 0 and p["chunks"] * port.BF_CH >= 256
    # staged index i holds image column x0 - 8 + i; the taps read x0 - 1 .. x0 + 32
    read = set(range(7, 7 + tw + 2))
    staged = set(range(port.BF_RP))
    assert read <= staged and max(staged) < port.BF_RP
    assert (th + 2) * port.BF_RP <= port.BF_PS and port.BF_PS % 32 == 8
    assert p["smem"] * p["min_blocks"] + 1024 * p["min_blocks"] <= port.CARD_SMEM
    assert p["accumulators"] + 4 * p["batch"] + 24 <= p["regs"]


@pytest.mark.parametrize("k", [1, 10, 26, 32])
@pytest.mark.parametrize("bhw", [(2, 57, 75), (1, 256, 320), (12, 228, 304), (1, 9, 11)])
def test_forward_reads_whole_16_byte_pieces(bhw, k):
    """K9-bf16 copies x 16 bytes at a time: where W % 8 != 0 (57x75) it
    reads a copy with rows of a multiple of 8 columns, zero past W, whose
    pieces of 8 columns start inside the image or lie wholly outside it
    (a piece starting before W ends before the pitch); otherwise x itself.
    The scratch holds the rounded weights of every chunk and that copy."""
    b, h, w = bhw
    p = fwd_plan_bf16(b, h, w, 192, 64, k)
    pitch = p["pitch"]
    assert pitch % 8 == 0 and w <= pitch < w + 8 and p["padded"] == (w % 8 != 0)
    for x0 in range(0, p["grid"][0] * port.BF_TILE[1], port.BF_TILE[1]):
        for x in range(x0 - 8, x0 + port.BF_RP - 8, 8):
            assert x < 0 or x >= w or x + 8 <= pitch
    weights = p["chunks"] * 9 * 16 * p["n"] // 2
    copy = b * 256 * h * pitch // 2 if w % 8 else 0
    assert p["scratch"] == weights + copy


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_chunk_order_matches_the_plain_version(shape):
    """K9-bf16's arithmetic in its order (each tap's f32 sum taken chunk by
    chunk of 16 channels, rounded; the nine rounded taps added in tap
    order, then the bias) within one ulp and the 1% bit-share bar of the
    plain version (bit-equal at these shapes)."""
    xa, xb, w, b, _ = _port(*_inputs(shape))
    got = small_conv3x3_bf16_chunks_plain(xa, xb, w, b)
    assert got.dtype == BF16
    err, share = _scores(got, small_conv3x3_plain_bf16(xa, xb, w, b).float().numpy())
    assert err <= ULP and share <= 0.01, (err, share)


def _reduce_order(parts):
    """bwd::reduce_partials' order, in float32 (up to 64 slices, then
    chunks of 64 in the same order)."""
    if parts.shape[0] <= port.RED_CHUNK:
        return port._reduce_partials(parts)
    chunks = [port._reduce_partials(parts[i:i + port.RED_CHUNK])
              for i in range(0, parts.shape[0], port.RED_CHUNK)]
    return _reduce_order(torch.stack(chunks))


@pytest.mark.parametrize("k", [1, 10, 26, 32])
@pytest.mark.parametrize("bhw", PLAN_SHAPES)
def test_backward_plan_covers_and_fits(bhw, k):
    """K9b-bf16: the 2x64 tiles cover every pixel once; the dx blocks'
    tile walks (j, j + blocks, ...) cover every tile once, and so do the dW
    slices' (s, s + slices, ...); the 9K rows and channels are covered by
    the block chunks; x and g are read in rows of a multiple of 8 columns
    (a padded copy where W % 8 != 0) whose 16-byte pieces lie wholly inside
    or outside them; shared memory fits ``dx_per_sm`` dx blocks and
    ``wg_per_sm`` dW blocks an SM (two at the heads' K 10 and 26); the
    accumulators fit the registers; the scratch holds the rounded weights,
    the padded copies and the slices' partial sums."""
    b, h, w = bhw
    p = bwd_plan_bf16(b, h, w, 192, 64, k)
    th, tw = port.BWD_BF_TILE
    assert (p["tiles_x"] - 1) * tw < w <= p["tiles_x"] * tw
    assert (p["tiles_y"] - 1) * th < h <= p["tiles_y"] * th
    assert p["tiles"] == b * p["tiles_x"] * p["tiles_y"]
    assert p["ksteps"] * 16 >= 9 * k > (p["ksteps"] - 1) * 16
    walks = [t for j in range(p["dx_blocks"]) for t in range(j, p["tiles"], p["dx_blocks"])]
    assert sorted(walks) == list(range(p["tiles"]))
    # dW beside dx on a second stream where dx's blocks walk few tiles:
    # the small shapes, not the train step's b=12
    assert p["side"] == (p["tiles"] <= 8 * p["dx_blocks"])
    if bhw == (12, 228, 304):
        assert not p["side"]
    if bhw == (2, 57, 75):
        assert p["side"]
    n, s = p["tiles"], p["slices"]
    slices = [list(range(i, n, s)) for i in range(s)]
    assert all(slices) and sorted(t for sl in slices for t in sl) == list(range(n))
    assert p["dx_chunks"] * p["dx_nc"] >= 256 > (p["dx_chunks"] - 1) * p["dx_nc"]
    assert p["mchunks"] * port.WG_MR >= 9 * k and p["cchunks"] * port.WG_NC >= 256
    pitch = p["pitch"]
    assert pitch % 8 == 0 and w <= pitch < w + 8 and p["copied"] == (w % 8 != 0)
    # g's staged box: rows y0 - 1 .. y0 + 2 read of its 5, columns x0 - 8 ..
    # x0 + 72 of its 88, the copy starting at a 16-byte boundary; a plane
    # (and a shifted copy's) an odd number of 16-byte pieces mod 128 bytes,
    # so ldmatrix's rows of 8 planes miss each other's banks
    assert port.BWD_BF_GP == 5 * port.BWD_BF_GW and th + 2 <= 5 and tw + 9 <= port.BWD_BF_GW
    for x0 in range(0, p["tiles_x"] * tw, tw):
        assert (x0 - 8) * 2 % 16 == 0
    for plane in (port.BWD_BF_GP, port.BWD_BF_PSS):
        assert (plane * 2 // 16) % 2 == 1 and plane * 2 % 16 == 0
    assert (th + 2) * port.BWD_BF_RPS <= port.BWD_BF_PSS and tw <= port.BWD_BF_RPS
    assert p["dx_per_sm"] * (p["dx_smem"] + 1024) <= port.CARD_SMEM
    assert p["wg_per_sm"] * (p["wg_smem"] + 1024) <= port.CARD_SMEM
    assert max(p["dx_smem"], p["wg_smem"]) <= port.BLOCK_SMEM_MAX
    assert p["dx_stages"] in (2, 3, 4) and p["wg_stages"] in (2, 3, 4)
    if k == 10:   # the heads' width: two blocks an SM
        assert p["dx_per_sm"] == p["wg_per_sm"] == 2
    # dx: NC / 2 accumulators, two A fragments; dW: the slice's sums, a
    # tile's and four fragments in flight
    assert p["dx_nc"] // 2 + 8 + 40 <= p["regs"] and 2 * port.WG_NC // 2 + 16 + 40 <= p["regs"]
    weights = p["dx_chunks"] * p["ksteps"] * 16 * p["dx_nc"] // 2
    copies = (-(-b * 256 * h * pitch // 2) + -(-b * k * h * pitch // 2)) if w % 8 else 0
    assert weights + copies + p["slices"] * (k * 256 * 9 + k) <= p["scratch"] \
        < weights + copies + p["slices"] * (k * 256 * 9 + k) + 12


@pytest.mark.parametrize("wd", [75, 76, 304])
def test_backward_padded_copy(wd):
    """K9b-bf16's copy (``pad_rows_bf16``, the mirror of ``pad_rows_kernel``)
    is x or g with zero columns up to the plan's pitch;
    dx from the padded copies, cut back to W columns, equals the plain
    version's dx bit for bit (the zero columns stand where the conv's zero
    padding stands), at W = 75 (odd), 76 (even, not a multiple of 8) and
    304 (a multiple of 8: no copy, the pitch is W)."""
    b, h, ca, cb, k = 1, 5, 64, 8, 10
    xa, xb, w, _, g = _port(*_inputs((b, h, wd, ca, cb, k), seed=wd))
    p = bwd_plan_bf16(b, h, wd, ca, cb, k)
    pitch = p["pitch"]
    assert p["copied"] == (wd != 304) and pitch == -(-wd // 8) * 8
    # dW's blocks of 64 channels would straddle xa and xb: x copied as one concat
    assert bwd_plan_bf16(b, h, wd, 24, 8, k)["copied"]
    gb = g.to(BF16)
    for t in (xa, xb, gb):
        tp = port.pad_rows_bf16(t, pitch)
        assert tp.dtype == t.dtype and tp.shape == t.shape[:-1] + (pitch,)
        assert torch.equal(tp[..., :wd], t) and not tp[..., wd:].any()
    want = small_conv3x3_bwd_plain_bf16(g, xa, xb, w)
    got = small_conv3x3_bwd_plain_bf16(*(port.pad_rows_bf16(t, pitch) for t in (gb, xa, xb)), w)
    for o, r in zip(got[:2], want[:2]):
        assert torch.equal(o[..., :wd], r)


def test_backward_slice_order_matches_plain():
    """K9b-bf16's dW and db summed in the kernel's split-K order (slice s
    takes tiles s, s + S, ...; each 2x64 tile's products, exact, summed
    apart and added to its slice; db by (plane, tile row, 8-column piece),
    a piece's columns in order each tile, the pieces added in order at the
    end; the slices added in ``reduce_slices_kernel``'s order, which is
    ``bwd::reduce_partials``') stay within 1e-5 of the plain version's f32
    sums: the order moves nothing past f32."""
    shape = (2, 9, 35, 24, 8, 10)
    xa, xb, w, _, g = _port(*_inputs(shape, seed=11))
    b, c, h, wd, k = 2, 32, 9, 35, 10
    p = bwd_plan_bf16(b, h, wd, 24, 8, k, sms=4)
    th, tw = port.BWD_BF_TILE
    hp, wp = -(-h // th) * th, -(-wd // tw) * tw
    x = F.pad(torch.cat([xa, xb], 1).float(), (1, 1 + wp - wd, 1, 1 + hp - h)).double()
    gr = F.pad(g.to(BF16).float(), (0, wp - wd, 0, hp - h))
    tiles = [(bi, y0, x0) for bi in range(b) for y0 in range(0, hp, th)
             for x0 in range(0, wp, tw)]
    assert len(tiles) == p["tiles"]
    s = p["slices"]
    parts = []
    for i in range(s):
        dw, dbp = torch.zeros(k, c, 3, 3), torch.zeros(k, th, tw // 8)
        for bi, y0, x0 in tiles[i::s]:
            gt = gr[bi, :, y0:y0 + th, x0:x0 + tw]
            t = torch.stack([torch.einsum("khw,chw->kc", gt.double(),
                                          x[bi, :, y0 + ty:y0 + ty + th, x0 + tx:x0 + tx + tw])
                             for ty in range(3) for tx in range(3)], -1)
            dw = dw + t.reshape(k, c, 3, 3).float()
            for e in range(8):   # column e of each piece
                dbp = dbp + gt[:, :, e::8]
        pieces = dbp.reshape(k, -1)
        db = pieces[:, 0]
        for j in range(1, pieces.shape[1]):
            db = db + pieces[:, j]
        parts.append(torch.cat([dw.reshape(-1), db]))
    total = _reduce_order(torch.stack(parts))
    want = small_conv3x3_bwd_plain_bf16(g, xa, xb, w)
    n_w = k * c * 9
    for got, ref in ((total[:n_w].view(k, c, 3, 3), want[2]), (total[n_w:], want[3])):
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("b,hg,wg,c", [(12, 58, 76, 256), (1, 58, 76, 256), (1, 57, 75, 256),
                                       (1, 58, 76, 30), (1, 60, 304, 256), (2, 3, 5, 30)])
def test_k4_bf16_plan_covers_and_fits(b, hg, wg, c):
    """K4-bf16's tensor-core passes: the dx blocks' walks cover every 4x16
    tile of the base grid once and the 128-channel groups cover C; the dW1
    slices' segments partition the b hg wg pixels in order, each inside one
    row, at most 32 pixels (two k-steps of 16); two blocks of either pass
    fit an SM (the dW1 pass on bf16 A and P: K4-bf16's x and dY1, K5-bf16's
    gm and p0)."""
    p = tail_bwd_plan_bf16(b, hg, wg, c)
    rows, cols = p["dx_grid_tiles"]
    assert (rows - 1) * 4 < hg <= rows * 4 and (cols - 1) * 16 < wg <= cols * 16
    walks = [t for j in range(p["dx_blocks"]) for t in range(j, p["dx_tiles"], p["dx_blocks"])]
    assert sorted(walks) == list(range(p["dx_tiles"])) == list(range(b * rows * cols))
    assert p["dx_groups"] * 128 >= c > (p["dx_groups"] - 1) * 128
    s = p["slices"]
    assert s == wgrad_s2_slices(b * hg * wg, c)
    flat = []
    for i in range(s):
        segs = wgrad_s2_segments(b, hg, wg, s, i)
        assert segs, "an empty slice"
        for bi, y, x0, ln in segs:
            assert 1 <= ln <= 32 and x0 + ln <= wg
            flat.extend((bi * hg + y) * wg + x for x in range(x0, x0 + ln))
    assert flat == list(range(b * hg * wg))
    for smem in (p["dx_smem"], p["wg_smem"]):
        assert 2 * (smem + 1024) <= port.CARD_SMEM
