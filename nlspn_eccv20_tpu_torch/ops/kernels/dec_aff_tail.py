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
``decode_aff_tail_bf16``: the same kernel on bf16 operands (the f32 weights
and biases rounded to bf16 as the kernel stages them), summing in f32 and
rounding y1 and the output to bf16 where the TPU kernel does; the output is
planar f32 holding bf16 values, as the TPU kernel stores it. Its plain
version is ``decode_aff_tail_plain_bf16``. Under autograd a bf16 ``x`` runs
``DecodeAffTailFunction`` too: K2-bf16 writes its y1 (rounded to bf16, held
in f32) and the backward is K4-bf16, ``decode_aff_tail_bwd_bf16`` (the
TPU backward at ``dt = bfloat16``; the same CUDA source), whose plain
version is ``decode_aff_tail_bwd_plain_bf16``: it rounds the cotangent, the
weights, dY1 and dx to bf16 where ``_bwd_kernel`` does, and returns a bf16
dx and f32 weight gradients.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dec_aff_tail_f32": [_P] * 7 + [_I] * 6 + [_P],
               "dec_aff_tail_bf16": [_P] * 7 + [_I] * 6 + [_P]}
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


# ---- K4-bf16's tensor-core passes, mirrored for the CPU tests ----
# (csrc/dec_aff_tail_bwd.cu's dx_mma_kernel and csrc/bwd_common.cuh's
# weight-gradient slices, which K5-bf16 shares)
CARD_SMS = 132                 # H100 SXM
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
    (``wg_groups`` of 128 channels, slices), ``wg_smem`` bytes for bf16 x
    and dY1 (``wg_smem_f32`` for K5-bf16's f32 gm and p0), reduced in
    ``bwd::reduce_partials``' order."""
    rows, cols = -(-hg // MX_TILE[0]), -(-wg // MX_TILE[1])
    tiles = b * rows * cols
    groups = -(-c // MX_NC)
    p_bf16, p_f32 = MID_CHANNELS * 3 * (2 * WG_SEG + 2) * 2, MID_CHANNELS * 3 * (2 * WG_SEG + 1) * 4
    step = MID_CHANNELS * 9 // 8 * 256
    a_bf16, a_f32 = WG_SEG * (WG_C + 8) * 2, WG_SEG * (WG_C + 4) * 4
    return {"dx_tiles": tiles, "dx_grid_tiles": (rows, cols), "dx_groups": groups,
            "dx_blocks": max(1, min(tiles, MX_BLOCKS_PER_SM * CARD_SMS // groups)),
            "dx_smem": 9 * MID_CHANNELS * MX_NC * 2 + 2 * MID_CHANNELS * MX_DMH * 2,
            "slices": wgrad_s2_slices(b * hg * wg, c), "wg_groups": -(-c // WG_C),
            "wg_smem": 2 * (a_bf16 + p_bf16) + 2 * step,
            "wg_smem_f32": 2 * (a_f32 + p_f32) + a_bf16 + 2 * step}


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
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((bsz, k, 4 * hg, 4 * wg), device=x.device, dtype=torch.float32)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    split = tail_plan(bsz, hg, wg, c, sms)[2]
    with torch.cuda.device(x.device):
        lib = build.load("dec_aff_tail", _SIGNATURES)
        err = (lib.dec_aff_tail_bf16 if bf16 else lib.dec_aff_tail_f32)(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(),
            y1.data_ptr() if y1 is not None else None, bsz, hg, wg, c, k, split,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "decode_aff_tail")
    (decode_aff_tail_bf16 if bf16 else decode_aff_tail).launches += 1
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
