"""Kernel K2: the decode_aff tail, deconv2(relu(deconv1(x))), and its
backward K4.

K2 replaces the TPU kernel ``dec_aff_tail._fwd_kernel``
(``nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py``). CUDA source:
``csrc/dec_aff_tail.cu``, whose header says what bounds it on the card (the
FP32 cores: 0.42 GFLOP at NYU size) and how the 16-channel intermediate
stays in shared memory; ``tail_plan`` picks its grid and the size of the
thread-block cluster that splits a tile's channels. K4 replaces the TPU
backward (``_deint_kernel`` and ``_bwd_kernel``, reached from
``_bwd_pallas``); CUDA source
``csrc/dec_aff_tail_bwd.cu``. Under autograd the forward kernel also writes
the intermediate y1, which K4 reads instead of recomputing deconv1.

``decode_aff_tail`` is differentiable: under autograd it runs
``DecodeAffTailFunction``, whose backward is K4 on a CUDA tensor and
``decode_aff_tail_bwd_plain`` on a CPU tensor.

On a bf16 ``x`` (``precision='bf16'``) it runs K2-bf16,
``decode_aff_tail_bf16`` (CUDA source ``csrc/dec_aff_tail_bf16.cu``, on the
bf16 tensor cores: its header says how): bf16 operands (the f32 weights and
biases rounded to bf16 once a call), sums in f32, y1 and the output rounded
to bf16 where the TPU kernel rounds them; the output is planar f32 holding
bf16 values, as the TPU kernel stores it. Its plain version is
``decode_aff_tail_plain_bf16``; ``tail_plan_bf16`` mirrors its launch plan
and ``decode_aff_tail_bf16_tiles`` its arithmetic, tile by tile, for the
CPU tests. Under autograd a bf16 ``x`` runs
``DecodeAffTailFunction`` too: K2-bf16 writes its y1 (rounded to bf16, held
in f32) and the backward is K4-bf16, ``decode_aff_tail_bwd_bf16`` (the
TPU backward at ``dt = bfloat16``; the same CUDA source as K4), whose plain
version is ``decode_aff_tail_bwd_plain_bf16``: it rounds the cotangent, the
weights, dY1 and dx to bf16 where ``_bwd_kernel`` does, and returns a bf16
dx and f32 weight gradients.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build, quad_mma

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dec_aff_tail_f32": [_P] * 7 + [_I] * 6 + [_P]}
_BF16_SIGNATURES = {
    "dec_aff_tail_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "dec_aff_tail_bf16_scratch_bytes": ([_I] * 2, ctypes.c_longlong),
    "dec_aff_tail_bf16_plan": [_I] * 6 + [_P],
}
_BWD_SIGNATURES = {
    "dec_aff_tail_bwd_f32": [_P] * 9 + [_I] * 5 + [_P],
    "dec_aff_tail_bwd_bf16": [_P] * 9 + [_I] * 5 + [_P],
    "dec_aff_tail_bwd_scratch_floats": ([_I] * 5, ctypes.c_longlong),
}
MID_CHANNELS = 16          # deconv1's output width, fixed by the model
OUT_CHANNELS = (8, 24)     # prop_kernel 3 and 5
TILE = (8, 16)             # K2's base-grid tile, rows x cols
STAGE = 16                 # K2's input channels a pipeline stage
SPLITS = (1, 2, 4, 8)      # K2's cluster sizes


def tail_plan(b: int, hg: int, wg: int, c: int, sms: int) -> Tuple[int, int, int]:
    """K2's grid on a card with ``sms`` SMs: (tile rows, tile cols, S). A
    cluster of S CTAs shares each 8x16 tile of the base grid, each summing
    ``tail_stages(c, S)``'s share of the channels; S is the smallest of 1,
    2, 4, 8 that gives two CTAs an SM, at most one per channel stage."""
    rows, cols = -(-hg // TILE[0]), -(-wg // TILE[1])
    s = 1
    while 2 * s in SPLITS and b * rows * cols * s < 2 * sms and 2 * s <= -(-c // STAGE):
        s *= 2
    return rows, cols, s


def tail_stages(c: int, s: int) -> List[Tuple[int, int]]:
    """The channel stages [k0, k1) (of ``STAGE`` channels, the last one
    masked past c) that each CTA of a cluster of s sums, rank by rank, as
    ``csrc/dec_aff_tail.cu`` splits them."""
    n = -(-c // STAGE)
    return [(r * n // s, (r + 1) * n // s) for r in range(s)]


# ---- K2-bf16 (csrc/dec_aff_tail_bf16.cu), mirrored for the CPU tests ----
CARD_SMS = 132                 # H100 SXM
BF16_TILE = (8, 16)            # base-grid tile, rows x cols
BF16_CHUNK = 32                # channels a chunk: two k-steps
BF16_THREADS = 384             # three warpgroups: tile rows 0-3, 4-7, the halo
BF16_Y1_TILE = (2 * BF16_TILE[0] + 1, 2 * BF16_TILE[1] + 1)   # y1 rows, cols with the halo


def tail_smem_bf16(k: int) -> int:
    """K2-bf16's dynamic shared memory: two chunk buffers (x's 9 x 17 pixels
    of 80 bytes, the chunk's B), where the f32 partial y1 tile later lies;
    the bf16 y1 tile of 48-byte pixels; deconv2's four B; the zero row."""
    stage = (BF16_TILE[0] + 1) * (BF16_TILE[1] + 1) * (BF16_CHUNK + 8) * 2 + \
        2 * quad_mma.KSTEP_BF16 * 2
    part = MID_CHANNELS * BF16_Y1_TILE[0] * BF16_Y1_TILE[1] * 4
    y1 = BF16_Y1_TILE[0] * BF16_Y1_TILE[1] * 24 * 2
    return max(2 * stage, part) + y1 + 2 * 4 * MID_CHANNELS * 4 * k + (BF16_CHUNK + 8) * 2


def tail_plan_bf16(b: int, hg: int, wg: int, c: int, k: int, sms: int) -> Dict[str, int]:
    """K2-bf16's launch plan, as ``plan`` in its source computes it: 8x16
    tiles of the base grid and the cluster size S, the largest of 1, 2, 4,
    8 whose CTAs (S a tile) all fit one wave of one CTA an SM, at most one
    a chunk of 32 channels."""
    rows, cols = -(-hg // BF16_TILE[0]), -(-wg // BF16_TILE[1])
    chunks = -(-c // BF16_CHUNK)
    s = 1
    while 2 * s <= 8 and b * rows * cols * 2 * s <= sms and 2 * s <= chunks:
        s *= 2
    return {"tiles_y": rows, "tiles_x": cols, "split": s, "threads": BF16_THREADS,
            "smem": tail_smem_bf16(k), "chunks": chunks}


def tail_chunks_bf16(c: int, s: int) -> List[Tuple[int, int]]:
    """The chunks of 32 channels [k0, k1) that each rank of a cluster of s
    sums, rank by rank, as ``csrc/dec_aff_tail_bf16.cu`` splits them."""
    n = -(-c // BF16_CHUNK)
    return [(r * n // s, (r + 1) * n // s) for r in range(s)]


def tail_plan_bf16_card(b: int, hg: int, wg: int, c: int, k: int, sms: int) -> Dict[str, int]:
    """The same plan as the built kernel reports it (``dec_aff_tail_bf16_plan``),
    for ``chip_smoke.py`` to hold against ``tail_plan_bf16``."""
    lib = build.load("dec_aff_tail_bf16", _BF16_SIGNATURES)
    out = (ctypes.c_int * 6)()
    build.check_launch(lib.dec_aff_tail_bf16_plan(b, hg, wg, c, k, sms, out),
                       "dec_aff_tail_bf16_plan")
    return dict(zip(("tiles_y", "tiles_x", "split", "threads", "smem", "chunks"), out))


def tail_m_rows_bf16() -> List[Optional[Tuple[int, int]]]:
    """The base pixel (i, j) of each of deconv1's 192 M rows (three
    warpgroups x four warps x 16), as ``m_row_pixel``: the tile's rows 0-7,
    then the halo (TH, 0..TW) and (0..TH-1, TW); None where a row reads the
    zero row."""
    th, tw = BF16_TILE
    rows = []
    for wg in range(3):
        for wr in range(4):
            for r in range(16):
                if wg < 2:
                    rows.append((4 * wg + wr, r))
                    continue
                h = 16 * wr + r
                rows.append((th, h) if h <= tw else (h - tw - 1, tw) if h < tw + 1 + th
                            else None)
    return rows


def _axis_tap(d: int, s: int) -> int:
    """``axis_tap``: the tap along one axis of a k3/s2/p1/op1 transposed conv
    for output parity d from input shift s; -1 where s does not feed d."""
    return (1 if s == 0 else -1) if d == 0 else (2 if s == 0 else 0)


def tail_pack_w2(w2: torch.Tensor) -> torch.Tensor:
    """(4, 16 x 4K) bf16: deconv2's B of each shift (sy, sx) = (s // 2, s %
    2) as ``prep_w2_kernel`` lays it out, columns n = 2K dy + 2k + dx, zero
    where the shift does not feed phase (dy, dx)."""
    k = w2.shape[1]
    w = w2.detach().float().cpu().reshape(MID_CHANNELS, k, 9)
    mm = torch.arange(MID_CHANNELS)
    out = torch.zeros(4, MID_CHANNELS * 4 * k, dtype=torch.bfloat16)
    for s, (sy, sx) in enumerate(quad_mma.SHIFTS):
        for n in range(4 * k):
            dy, kk, dx = n // (2 * k), (n % (2 * k)) // 2, n % 2
            ty, tx = _axis_tap(dy, sy), _axis_tap(dx, sx)
            if ty >= 0 and tx >= 0:
                out[s, quad_mma.kmajor_index(torch.tensor(n), mm)] = (
                    w[:, kk, 3 * ty + tx].to(torch.bfloat16))
    return out


def decode_aff_tail_bf16_tiles(x, w1, b1, w2, b2, split: Optional[int] = None):
    """K2-bf16's arithmetic on the CPU, tile by tile as the kernel runs it:
    the packed operands (``quad_mma.pack``, ``tail_pack_w2``), deconv1 as
    each cluster rank's f32 sums over its chunks (``quad_mma.mma_kstep`` on
    the 192 M rows of ``tail_m_rows_bf16``; past the staged tile and past
    the image, zeros), the partials added in rank order, the bias, ReLU,
    image mask and one bf16 rounding, deconv2 on the tensor-core columns
    and one rounding after the bias. ``split`` defaults to the plan's S on
    the card. Returns (out, y1) as ``decode_aff_tail_fwd_y1`` gives them;
    the sums run in another order than the tensor cores', as the plain
    version's do."""
    bsz, hg, wg, c = x.shape
    k = w2.shape[1]
    th, tw = BF16_TILE
    yr, yc = BF16_Y1_TILE
    m = MID_CHANNELS
    plan = tail_plan_bf16(bsz, hg, wg, c, k, CARD_SMS)
    s_split = plan["split"] if split is None else split
    chunks = plan["chunks"]
    wp1, wp2 = quad_mma.pack(w1, 2 * chunks), tail_pack_w2(w2)
    b2ops = [quad_mma.b_operand(wp2[s], 0, 4 * k) for s in range(4)]
    rb1, rb2 = _bf16(b1.detach().float().cpu()), _bf16(b2.detach().float().cpu())
    xf = torch.zeros(bsz, hg + th + 1, wg + tw + 1, chunks * BF16_CHUNK)
    xf[:, :hg, :wg, :c] = x.detach().cpu().float()
    rows = tail_m_rows_bf16()
    out = torch.empty(bsz, k, 4 * hg, 4 * wg)
    y1 = torch.empty(bsz, m, 2 * hg, 2 * wg)
    for b in range(bsz):
        for a0 in range(0, hg, th):
            for t0 in range(0, wg, tw):
                # each shift's A rows: the staged pixel, zero past the
                # image; the zero row past the staged tile
                zero = torch.zeros(xf.shape[3])
                a_rows = [torch.stack([
                    xf[b, a0 + ij[0] + sy, t0 + ij[1] + sx]
                    if ij is not None and ij[0] + sy <= th and ij[1] + sx <= tw else zero
                    for ij in rows]) for sy, sx in quad_mma.SHIFTS]
                part = torch.zeros(s_split, m, yr, yc)
                for rank in range(s_split):
                    acc = torch.zeros(len(rows), 64)
                    for kc in range(rank * chunks // s_split, (rank + 1) * chunks // s_split):
                        for ks in (2 * kc, 2 * kc + 1):
                            sl = slice(ks * quad_mma.KSTEP, (ks + 1) * quad_mma.KSTEP)
                            quad_mma.mma_kstep(acc, [a[:, sl] for a in a_rows], wp1[ks])
                    for row, ij in enumerate(rows):
                        if ij is None:
                            continue
                        for q, (dy, dx) in enumerate(quad_mma.PHASES):
                            v, u = 2 * ij[0] + dy, 2 * ij[1] + dx
                            if v < yr and u < yc:
                                part[rank, :, v, u] = acc[row, 16 * q:16 * q + 16]
                total = part[0]
                for rank in range(1, s_split):
                    total = total + part[rank]
                vv = (2 * a0 + torch.arange(yr))[:, None] < 2 * hg
                uu = (2 * t0 + torch.arange(yc))[None, :] < 2 * wg
                yt = _bf16(torch.where(vv & uu, (total + rb1[:, None, None]).relu(),
                                       torch.zeros(())))
                ys = slice(2 * a0, min(2 * a0 + 2 * th, 2 * hg))
                xs = slice(2 * t0, min(2 * t0 + 2 * tw, 2 * wg))
                y1[b, :, ys, xs] = yt[:, :ys.stop - ys.start, :xs.stop - xs.start]
                # deconv2: a row per y1 pixel (v, u) of the tile's 2TH x 2TW
                o = torch.zeros(2 * th * 2 * tw, 4 * k)
                for (sy, sx), bop in zip(quad_mma.SHIFTS, b2ops):
                    a2 = yt[:, sy:sy + 2 * th, sx:sx + 2 * tw].reshape(m, -1).t()
                    o += a2 @ bop
                o = _bf16(o.view(2 * th, 2 * tw, 2, k, 2) + rb2[None, None, None, :, None])
                # (v, u, dy, k, dx) -> out[k][4 a0 + 2v + dy][4 t0 + 2u + dx]
                blk = o.permute(3, 0, 2, 1, 4).reshape(k, 4 * th, 4 * tw)
                oy = slice(4 * a0, min(4 * a0 + 4 * th, 4 * hg))
                ox = slice(4 * t0, min(4 * t0 + 4 * tw, 4 * wg))
                out[b, :, oy, ox] = blk[:, :oy.stop - oy.start, :ox.stop - ox.start]
    return out, y1


# ---- K4-bf16's tensor-core passes, mirrored for the CPU tests ----
# (csrc/dec_aff_tail_bwd.cu's dx_mma_kernel and csrc/bwd_common.cuh's
# weight-gradient slices, which K5-bf16 shares)
MX_TILE, MX_NC = (4, 16), 128  # dx: base-pixel tile (M = 64), channels a block (N)
MX_BLOCKS_PER_SM = 2
WG_C, WG_SEG, WG_MIN_PIXELS = 128, 32, 64   # dW: channels a block; pixels a segment, a slice
MX_DMH = 9 * 48 + 8            # bf16 of a staged dY1 m: 9 patch rows of 48, padded


def wgrad_s2_slices(n_pixels: int, c: int) -> int:
    """``bwd::wgrad_s2_slices``: two blocks of 128 channels on each SM of
    the card, each slice at least 64 pixels."""
    groups = -(-c // WG_C)
    want = -(-2 * CARD_SMS // groups)
    most = n_pixels // WG_MIN_PIXELS
    return want if want < most else max(most, 1)


def wgrad_s2_segments(b: int, ha: int, wa: int, slices: int, s: int):
    """The row segments (image, row, first column, length) that slice ``s``
    of ``slices`` walks, in order, as ``wgrad_s2_kernel`` and
    ``wgrad_s2_mma_kernel`` stage them: the flat pixel range [N s / S, N (s
    + 1) / S), N = b ha wa, cut at row ends and every 32 pixels. The
    tensor-core form sums each segment in two k-steps of 16 pixels, zeros
    past its length."""
    n = b * ha * wa
    beg, left = n * s // slices, n * (s + 1) // slices - n * s // slices
    row, j = divmod(beg, wa)
    segs = []
    while left > 0:
        ln = min(WG_SEG, wa - j, left)
        segs.append((row // ha, row % ha, j, ln))
        left -= ln
        j += ln
        if j == wa:
            row, j = row + 1, 0
    return segs


def tail_bwd_plan_bf16(b: int, hg: int, wg: int, c: int):
    """K4-bf16's two tensor-core passes as they launch: dx over ``dx_tiles``
    4x16 tiles of the base grid, grid (``dx_groups`` of 128 channels,
    ``dx_blocks`` persistent blocks), block j walking tiles j, j +
    dx_blocks, ..., ``dx_smem`` bytes (the group's 36,864 bytes of rounded
    weights and two buffers of the 16 bf16 dY1 planes' 9 x 48 patch); dW1
    over ``slices`` split-K slices of the b hg wg pixels, grid
    (``wg_groups`` of 128 channels, slices), ``wg_smem`` bytes for bf16 A
    and P (K4-bf16's x and dY1, K5-bf16's gm and p0), reduced in
    ``bwd::reduce_partials``' order."""
    rows, cols = -(-hg // MX_TILE[0]), -(-wg // MX_TILE[1])
    tiles = b * rows * cols
    groups = -(-c // MX_NC)
    return {"dx_tiles": tiles, "dx_grid_tiles": (rows, cols), "dx_groups": groups,
            "dx_blocks": max(1, min(tiles, MX_BLOCKS_PER_SM * CARD_SMS // groups)),
            "dx_smem": 9 * MID_CHANNELS * MX_NC * 2 + 2 * MID_CHANNELS * MX_DMH * 2,
            "slices": wgrad_s2_slices(b * hg * wg, c), "wg_groups": -(-c // WG_C),
            "wg_smem": wgrad_s2_smem()}


def wgrad_s2_smem() -> int:
    """``bwd::WGM_SMEM``: two buffers of a segment's bf16 A rows (32 x 136)
    and P rows (16 m x 3 rows x 66 columns), and two k-steps' Pcol."""
    return (2 * (WG_SEG * (WG_C + 8) * 2 + MID_CHANNELS * 3 * (2 * WG_SEG + 2) * 2)
            + 2 * MID_CHANNELS * 9 // 8 * 256)


def _deconv(y, w):
    return F.conv_transpose2d(y, w, None, 2, 1, 1)


def decode_aff_tail_plain_y1(x, w1, b1, w2, b2):
    """``decode_aff_tail_plain``'s output and its intermediate y1."""
    y1 = F.relu(F.conv_transpose2d(x.permute(0, 3, 1, 2), w1, b1, 2, 1, 1))
    return F.conv_transpose2d(y1, w2, b2, 2, 1, 1).contiguous(), y1


def decode_aff_tail_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Two ``conv_transpose2d`` (k3/s2/p1/op1) with a ReLU between them."""
    return decode_aff_tail_plain_y1(x, w1, b1, w2, b2)[0]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, held in f32."""
    return t.to(torch.bfloat16).float()


def decode_aff_tail_plain_bf16_y1(x, w1, b1, w2, b2):
    """``decode_aff_tail_plain_bf16``'s output and its intermediate y1
    (rounded to bf16, held in f32), which K2-bf16 writes for K4-bf16."""
    y1 = _bf16(F.relu(F.conv_transpose2d(_bf16(x).permute(0, 3, 1, 2), _bf16(w1),
                                         _bf16(b1), 2, 1, 1)))
    out = _bf16(F.conv_transpose2d(y1, _bf16(w2), _bf16(b2), 2, 1, 1)).contiguous()
    return out, y1


def decode_aff_tail_plain_bf16(x, w1, b1, w2, b2):
    """K2-bf16's plain version: x, the weights and the biases rounded to
    bf16, each transposed conv summed in f32 with its bias added in f32, y1
    rounded to bf16 after its ReLU and the output rounded to bf16, as the
    TPU kernel (``_fwd_kernel``) rounds them. Planar f32 holding bf16
    values."""
    return decode_aff_tail_plain_bf16_y1(x, w1, b1, w2, b2)[0]


def decode_aff_tail_bwd_plain(g, x, w1, w2, y1):
    """K4's plain version, on K4's inputs: (dx, dw1, db1, dw2, db2) at
    cotangent g, from the forward's input x and its intermediate y1 (whose
    ReLU mask it uses, as K4 does)."""
    _, vjp2 = torch.func.vjp(_deconv, y1, w2)
    d_y1, dw2 = vjp2(g)
    d_y1 = d_y1 * (y1 > 0)
    _, vjp1 = torch.func.vjp(lambda a, w: _deconv(a.permute(0, 3, 1, 2), w), x, w1)
    dx, dw1 = vjp1(d_y1)
    return dx.contiguous(), dw1, d_y1.sum((0, 2, 3)), dw2, g.sum((0, 2, 3))


def decode_aff_tail_bwd_plain_bf16(g, x, w1, w2, y1):
    """K4-bf16's plain version, on its inputs (x bf16, y1 the bf16 values
    K2-bf16 writes, g f32): ``decode_aff_tail_bwd_plain`` rounding where the
    TPU kernel (``_bwd_kernel`` at ``dt = bfloat16``) rounds: g, w1 and w2
    to bf16 first, dY1 to bf16 after its f32 sum and ReLU mask, dx to bf16
    after its f32 sum (returned bf16). The weight and bias gradients are f32
    sums of the rounded operands, db2 of the rounded g. The mask is
    [y1 > 0], where the TPU kernel takes [P > 0] on the f32 value before
    rounding: the two differ only where 0 < P <= 2^-134
    (``csrc/dec_aff_tail_bwd.cu`` bounds that case)."""
    g = _bf16(g)
    _, vjp2 = torch.func.vjp(_deconv, y1, _bf16(w2))
    d_y1, dw2 = vjp2(g)
    d_y1 = _bf16(d_y1 * (y1 > 0))
    _, vjp1 = torch.func.vjp(lambda a, w: _deconv(a.permute(0, 3, 1, 2), w),
                             x.float(), _bf16(w1))
    dx, dw1 = vjp1(d_y1)
    return (dx.to(torch.bfloat16).contiguous(), dw1, d_y1.sum((0, 2, 3)), dw2,
            g.sum((0, 2, 3)))


def _check_inputs(x, w1, b1, w2, b2):
    c, k = x.shape[3], w2.shape[1]
    if k not in OUT_CHANNELS:
        raise ValueError(f"decode_aff_tail: K = {k}, the kernel takes {OUT_CHANNELS}")
    dev = x.device
    build.check_tensor(x, "decode_aff_tail x",
                       dtype=torch.bfloat16 if x.dtype == torch.bfloat16 else None)
    build.check_tensor(w1, "decode_aff_tail w1", (c, MID_CHANNELS, 3, 3), dev)
    if w1.data_ptr() % 16:
        raise ValueError("decode_aff_tail w1: expected 16-byte alignment")
    build.check_tensor(w2, "decode_aff_tail w2", (MID_CHANNELS, k, 3, 3), dev)
    if b1 is not None:
        build.check_tensor(b1, "decode_aff_tail b1", (MID_CHANNELS,), dev)
        build.check_tensor(b2, "decode_aff_tail b2", (k,), dev)


def _launch_fwd(x, w1, b1, w2, b2, y1: Optional[torch.Tensor] = None):
    bsz, hg, wg, c = x.shape
    k = w2.shape[1]
    _check_inputs(x, w1, b1, w2, b2)
    if y1 is not None:
        build.check_tensor(y1, "decode_aff_tail y1",
                           (bsz, MID_CHANNELS, 2 * hg, 2 * wg), x.device)
    out = torch.empty((bsz, k, 4 * hg, 4 * wg), device=x.device, dtype=torch.float32)
    y1_ptr = y1.data_ptr() if y1 is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:   # K2-bf16: it plans its own grid
            lib = build.load("dec_aff_tail_bf16", _BF16_SIGNATURES)
            scratch = torch.empty(lib.dec_aff_tail_bf16_scratch_bytes(c, k),
                                  device=x.device, dtype=torch.uint8)
            err = lib.dec_aff_tail_bf16(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), y1_ptr, scratch.data_ptr(), bsz, hg, wg, c, k, stream)
            build.check_launch(err, "decode_aff_tail_bf16")
            decode_aff_tail_bf16.launches += 1
            return out
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        lib = build.load("dec_aff_tail", _SIGNATURES)
        err = lib.dec_aff_tail_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), y1_ptr, bsz, hg, wg, c, k, tail_plan(bsz, hg, wg, c, sms)[2],
            stream)
    build.check_launch(err, "decode_aff_tail")
    decode_aff_tail.launches += 1
    return out


def decode_aff_tail_fwd_y1(x, w1, b1, w2, b2):
    """K2's output and the intermediate y1 (B, 16, 2Hg, 2Wg) f32 that K4
    reads (K2-bf16's and K4-bf16's on a bf16 ``x``: y1 holds bf16 values).
    On a CPU tensor it runs ``decode_aff_tail_plain_y1`` (or
    ``decode_aff_tail_plain_bf16_y1``)."""
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            return decode_aff_tail_plain_bf16_y1(x, w1, b1, w2, b2)
        return decode_aff_tail_plain_y1(x, w1, b1, w2, b2)
    bsz, hg, wg, _ = x.shape
    y1 = torch.empty((bsz, MID_CHANNELS, 2 * hg, 2 * wg), device=x.device,
                     dtype=torch.float32)
    return _launch_fwd(x, w1, b1, w2, b2, y1), y1


def decode_aff_tail_bwd(g, x, w1, w2, y1):
    """K4: (dx, dw1, db1, dw2, db2) at cotangent ``g`` (B, K, 4Hg, 4Wg), from
    the forward's input and its intermediate ``y1``. On a CPU tensor it
    runs ``decode_aff_tail_bwd_plain``; on a CUDA tensor it launches the
    kernel or raises. A bf16 ``x`` goes to ``decode_aff_tail_bwd_bf16``."""
    if x.dtype == torch.bfloat16:
        return decode_aff_tail_bwd_bf16(g, x, w1, w2, y1)
    if x.device.type == "cpu":
        return decode_aff_tail_bwd_plain(g, x, w1, w2, y1)
    return _launch_bwd(g, x, w1, w2, y1)


def decode_aff_tail_bwd_bf16(g, x, w1, w2, y1):
    """K4-bf16: ``decode_aff_tail_bwd`` on a bf16 ``x``, with the y1 that
    K2-bf16 wrote and an f32 ``g``. Returns dx bf16 and the weight and bias
    gradients f32. On a CPU tensor it runs
    ``decode_aff_tail_bwd_plain_bf16``; on a CUDA tensor it launches the
    kernel or raises."""
    if x.device.type == "cpu":
        return decode_aff_tail_bwd_plain_bf16(g, x, w1, w2, y1)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"decode_aff_tail_bwd_bf16 x: expected bfloat16, got {x.dtype}")
    return _launch_bwd(g, x, w1, w2, y1)


def _launch_bwd(g, x, w1, w2, y1):
    bsz, hg, wg, c = x.shape
    k = w2.shape[1]
    dev = x.device
    _check_inputs(x, w1, None, w2, None)
    build.check_tensor(y1, "decode_aff_tail_bwd y1",
                       (bsz, MID_CHANNELS, 2 * hg, 2 * wg), dev)
    build.check_tensor(g, "decode_aff_tail_bwd g", (bsz, k, 4 * hg, 4 * wg), dev)
    dx = torch.empty_like(x)
    dw1 = torch.empty_like(w1)
    m = MID_CHANNELS
    dw2b = torch.empty(m * k * 9 + m + k, device=dev, dtype=torch.float32)
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        lib = build.load("dec_aff_tail_bwd", _BWD_SIGNATURES)
        scratch = torch.empty(lib.dec_aff_tail_bwd_scratch_floats(bsz, hg, wg, c, k),
                              device=dev, dtype=torch.float32)
        err = (lib.dec_aff_tail_bwd_bf16 if bf16 else lib.dec_aff_tail_bwd_f32)(
            x.data_ptr(), y1.data_ptr(), g.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), dx.data_ptr(), dw1.data_ptr(), dw2b.data_ptr(),
            scratch.data_ptr(), bsz, hg, wg, c, k,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "decode_aff_tail_bwd")
    (decode_aff_tail_bwd_bf16 if bf16 else decode_aff_tail_bwd).launches += 1
    dw2 = dw2b[:m * k * 9].view(m, k, 3, 3)
    return dx, dw1, dw2b[m * k * 9:m * k * 9 + m], dw2, dw2b[m * k * 9 + m:]


class DecodeAffTailFunction(torch.autograd.Function):
    """K2 forward, K4 backward (their plain versions on CPU tensors); on a
    bf16 ``x`` K2-bf16 and K4-bf16."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        out, y1 = decode_aff_tail_fwd_y1(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, w2, y1)
        return out

    @staticmethod
    def backward(ctx, g):
        return decode_aff_tail_bwd(g.contiguous(), *ctx.saved_tensors)


def decode_aff_tail(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x: (B, Hg, Wg, C) NHWC, f32 or bf16; w1: (C, 16, 3, 3), b1: (16,);
    w2: (16, K, 3, 3), b2: (K,) f32 in torch ConvTranspose2d layout, K = 8
    or 24. Returns planar (B, K, 4Hg, 4Wg) f32. A bf16 ``x`` goes to
    ``decode_aff_tail_bf16``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return DecodeAffTailFunction.apply(x, w1, b1, w2, b2)
    if x.dtype == torch.bfloat16:
        return decode_aff_tail_bf16(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return decode_aff_tail_plain(x, w1, b1, w2, b2)
    return _launch_fwd(x, w1, b1, w2, b2)


def decode_aff_tail_bf16(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K2-bf16: ``decode_aff_tail`` on a bf16 ``x``, the weights and biases
    f32 (the kernel rounds them to bf16). Returns planar (B, K, 4Hg, 4Wg)
    f32 holding bf16 values. On a CPU tensor it runs
    ``decode_aff_tail_plain_bf16``; on a CUDA tensor it launches the kernel
    or raises. Under autograd it runs ``DecodeAffTailFunction``, whose
    backward is K4-bf16."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return DecodeAffTailFunction.apply(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return decode_aff_tail_plain_bf16(x, w1, b1, w2, b2)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"decode_aff_tail_bf16 x: expected bfloat16, got {x.dtype}")
    return _launch_fwd(x, w1, b1, w2, b2)


decode_aff_tail.launches = 0
decode_aff_tail_bf16.launches = 0
decode_aff_tail_bwd.launches = 0
decode_aff_tail_bwd_bf16.launches = 0


def decode_aff_tail_case(gen: torch.Generator, device, b: int, hg: int,
                         wg: int, k: int = 8, c: int = 256):
    """Inputs on which K2 is checked and timed on the card, from ``gen``: a
    ReLU'd base grid hg x wg x c (what deconv0's ReLU gives) and both
    transposed convs' weights at their init scale, K = k. Returns (args of
    ``decode_aff_tail`` and its plain version, library): the library call is
    cuDNN's two ``conv_transpose2d`` with the ReLU between them, on x already
    in NCHW, a yardstick that the port itself never calls."""
    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(device)
    m = MID_CHANNELS
    x = randn(b, hg, wg, c).relu()
    w1, b1 = randn(c, m, 3, 3, std=(c * 9 / 4) ** -0.5), randn(m, std=0.1)
    w2, b2 = randn(m, k, 3, 3, std=(m * 9 / 4) ** -0.5), randn(k, std=0.1)
    xn = x.permute(0, 3, 1, 2).contiguous()

    def library():
        y1 = F.relu(F.conv_transpose2d(xn, w1, b1, 2, 1, 1))
        return F.conv_transpose2d(y1, w2, b2, 2, 1, 1)

    return (x, w1, b1, w2, b2), library


def decode_aff_tail_bwd_case(gen: torch.Generator, device, b: int, hg: int,
                             wg: int, k: int, c: int = 256,
                             dtype: torch.dtype = torch.float32):
    """Inputs on which K4 (K4-bf16 with ``dtype=torch.bfloat16``) is
    checked and timed on the card, from ``gen``: ``decode_aff_tail_case``'s
    x (in ``dtype``) and weights, the forward's y1, and g, zero below row
    228 of the output when the grid is NYU's 58 rows (the model trims the
    232 rows to 228). Returns (args of ``decode_aff_tail_bwd`` and its plain
    version, library): the library call is cuDNN's backward of the same two
    convs (aten.convolution_backward, what autograd runs for them; in bf16
    on bf16 tensors and weights), a yardstick that the port itself never
    calls."""
    m = MID_CHANNELS
    (x, w1, b1, w2, b2), _ = decode_aff_tail_case(gen, device, b, hg, wg, k, c)
    x = x.to(dtype)
    _, y1 = decode_aff_tail_fwd_y1(x, w1, b1, w2, b2)
    g = torch.randn((b, k, 4 * hg, 4 * wg), generator=gen).to(device)
    if hg == 58:
        g[:, :, 228:] = 0.0
    xn, yn, gn = (t.to(dtype) for t in (x.permute(0, 3, 1, 2).contiguous(), y1, g))
    w1n, w2n = w1.to(dtype), w2.to(dtype)
    conv_bwd = torch.ops.aten.convolution_backward

    def library():
        d_y1, d_w2, d_b2 = conv_bwd(gn, yn, w2n, [k], [2, 2], [1, 1], [1, 1],
                                    True, [1, 1], 1, [True, True, True])
        d_y1 = torch.ops.aten.threshold_backward(d_y1, yn, 0.0)
        return conv_bwd(d_y1, xn, w1n, [m], [2, 2], [1, 1], [1, 1], True,
                        [1, 1], 1, [True, True, True]) + (d_w2, d_b2)

    return (g, x, w1, w2, y1), library
