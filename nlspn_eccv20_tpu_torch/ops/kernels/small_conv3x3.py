"""Kernel K9: a 3x3 stride-1 convolution of concat(xa, xb) with few outputs,
planar in and out, and its backward K9b.

K9 replaces the TPU kernel ``small_conv3x3._fwd_kernel`` (reached from
``_fwd_pallas``, ``nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py``); CUDA
source ``csrc/small_conv3x3.cu``. K9b replaces its backward
(``_bwd_kernel``, reached from ``_bwd_pallas``); CUDA source
``csrc/small_conv3x3_bwd.cu``. Both run their products on the tensor cores
as error-compensated 3xTF32 at f32 accuracy (``csrc/wgmma_tf32.cuh``).

What bounds them on the card: in f32 FMAs the forward is 2.2x its bytes at
NYU's b=12 (572 against 264 us) and the backward 2.2x too, so plain f32
arithmetic makes them operation-bound (K9's first form ran at 26% of the
FMA peak). On ``wgmma`` the three TF32 passes fall under the bytes, so
both designs aim at the bytes: K9 as an implicit GEMM, M the pixels, N
the K outputs rounded up to 8, the reduction over (channel, tap) in k-steps
of 8 channels of one tap, its A built in registers from a staged x tile
with its halo, its weights split once a call; K9b as two such products
(dx, and dW as split-K over pixel slices). Each source's header gives the
layout.

The op was built for the heads' stage-2 conv (the JAX package's
``models/nlspn.Heads``): xa the three heads' stage-1 outputs, xb ``fe1``,
K = 1 + num_neighbors + 1 outputs (3 num_neighbors + 2 with ``offset``).
Neither model routes through it; it is an op-library primitive, and
``fuse_heads_dec0`` builds the fused stage-2 weights it takes there.

``small_conv3x3_planar`` is differentiable: under autograd it runs
``SmallConv3x3Function``, whose backward is K9b on a CUDA tensor and
``small_conv3x3_bwd_plain`` on a CPU tensor.

On a bf16 ``xa`` it runs K9-bf16, ``small_conv3x3_bf16`` (CUDA source
``csrc/small_conv3x3_bf16.cu``), and under autograd its backward K9b-bf16,
``small_conv3x3_bwd_bf16`` (``csrc/small_conv3x3_bwd_bf16.cu``): the TPU
kernels at ``dt = bfloat16``. xb is cast to xa's dtype, the weights and the
bias (f32 or bf16) are rounded to bf16. The forward rounds each tap's f32
sum over the channels to bf16, sums the nine rounded taps and the bias in
f32 and rounds again, as ``_fwd_kernel`` does (one rounding of the whole
sum differs on about 40% of the outputs at the heads' widths); the
backward rounds g, sums dx in f32 and rounds it once, and returns f32 dW
and db, which autograd casts to the leaves' dtypes. Their plain versions,
``small_conv3x3_plain_bf16`` and ``small_conv3x3_bwd_plain_bf16``, repeat
that arithmetic in PyTorch (per-tap 1x1 products, never one bf16 conv) for
the CPU and for the card's checks; nothing on the card's path uses them.

For the CPU tests, ``fwd_plan`` and ``bwd_plan`` mirror the kernels'
launches (``fwd_plan_bf16`` and ``bwd_plan_bf16`` the bf16 forms'), and
``small_conv3x3_split_plain`` and ``small_conv3x3_bwd_split_plain`` their
arithmetic (the TF32 split, in the kernels' order;
``small_conv3x3_bf16_chunks_plain`` K9-bf16's, ``pad_rows_bf16``
K9b-bf16's copy of x and g); ``small_conv3x3_case``
and ``small_conv3x3_bwd_case`` build the inputs on which the card times
both kernels, in f32 or bf16.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import case_rng

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "small_conv3x3_f32": [_P] * 6 + [_I] * 6 + [_P],
    "small_conv3x3_scratch_floats": ([_I] * 6, ctypes.c_longlong),
}
_BWD_SIGNATURES = {
    "small_conv3x3_bwd_f32": [_P] * 8 + [_I] * 6 + [_P],
    "small_conv3x3_bwd_scratch_floats": ([_I] * 6, ctypes.c_longlong),
}
_BF16_SIGNATURES = {
    "small_conv3x3_bf16": [_P] * 6 + [_I] * 6 + [_P],
    "small_conv3x3_bf16_plan": [_I] * 4 + [_P],
    "small_conv3x3_bf16_scratch_floats": ([_I] * 6, ctypes.c_longlong),
}
_BWD_BF16_SIGNATURES = {
    "small_conv3x3_bwd_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "small_conv3x3_bwd_bf16_plan": [_I] * 6 + [_P],
    "small_conv3x3_bwd_bf16_scratch_floats": ([_I] * 6, ctypes.c_longlong),
}
MAX_K = 32                 # outputs the kernels' register tiles hold
BF16 = torch.bfloat16


def small_conv3x3_plain(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` (padding 1) over the channel concat of xa and xb."""
    return F.conv2d(torch.cat([xa, xb], 1), w, b, padding=1)


def small_conv3x3_bwd_plain(g: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                            w: torch.Tensor):
    """(dxa, dxb, dw, db) of ``small_conv3x3_plain`` at cotangent ``g``
    (B, K, H, W), through ``torch.func.vjp``."""
    _, vjp = torch.func.vjp(small_conv3x3_plain, xa, xb, w,
                            w.new_zeros(w.shape[0]))
    return vjp(g)


def small_conv3x3_plain_bf16(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """K9-bf16's arithmetic, the TPU kernel's at ``dt = bfloat16``: x, the
    weights and the bias rounded to bf16; per tap a 1x1 product over all
    Ca + Cb channels summed in f32 and rounded to bf16; the nine rounded
    taps added in f32 in tap order, then the bias, and rounded. Returns
    (B, K, H, W) bf16."""
    x = torch.cat([xa.to(BF16), xb.to(BF16)], 1).float()
    wr = w.to(BF16).float()
    h, wd = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1))
    total = None
    for ty in range(3):
        for tx in range(3):
            tap = F.conv2d(xp[:, :, ty:ty + h, tx:tx + wd], wr[:, :, ty:ty + 1, tx:tx + 1])
            tap = tap.to(BF16).float()
            total = tap if total is None else total + tap
    return (total + b.to(BF16).float()[:, None, None]).to(BF16)


def small_conv3x3_bwd_plain_bf16(g: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                                 w: torch.Tensor):
    """K9b-bf16's arithmetic, the TPU backward's at ``dt = bfloat16``: g and
    the weights rounded to bf16; dx the f32 sum of their products rounded
    once to bf16; dW the f32 sum over the pixels of the bf16 x times the
    rounded g; db the f32 sum of the rounded g. Returns (dxa, dxb) bf16 and
    (dw, db) f32."""
    x = torch.cat([xa.to(BF16), xb.to(BF16)], 1).float()
    gr = g.to(BF16).float()
    _, vjp = torch.func.vjp(lambda xx, ww: F.conv2d(xx, ww, None, padding=1), x,
                            w.to(BF16).float())
    dx, dw = vjp(gr)
    ca = xa.shape[1]
    return dx[:, :ca].to(BF16), dx[:, ca:].to(BF16), dw, gr.sum((0, 2, 3))


def fuse_heads_dec0(dec0: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The heads' stage-2 convs as one K9 weight, as the JAX package's
    ``Heads`` assembles its fused kernel: ``dec0`` holds each head's
    (weight (n_i, width + C_skip, 3, 3), bias (n_i,)); head i's outputs read
    its own stage-1 channels [i width, (i + 1) width) and the shared skip
    channels after all heads', zeros elsewhere. Returns (w (K, n_heads
    width + C_skip, 3, 3), b (K,))."""
    n_heads = len(dec0)
    skip = dec0[0][0].shape[1] - width
    blocks = []
    for i, (wi, _) in enumerate(dec0):
        blk = wi.new_zeros((wi.shape[0], n_heads * width + skip, 3, 3))
        blk[:, i * width:(i + 1) * width] = wi[:, :width]
        blk[:, n_heads * width:] = wi[:, width:]
        blocks.append(blk)
    return torch.cat(blocks), torch.cat([bi for _, bi in dec0])


def _check_args(xa, xb, w, b):
    bsz, ca, h, wd = xa.shape
    k = w.shape[0]
    if xb.dim() != 4 or xb.shape[0] != bsz or xb.shape[2:] != (h, wd):
        raise ValueError(f"xb shape {tuple(xb.shape)} does not match xa "
                         f"{tuple(xa.shape)}")
    if w.shape != (k, ca + xb.shape[1], 3, 3) or b.shape != (k,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)}: expected "
                         f"(K, {ca + xb.shape[1]}, 3, 3) / (K,)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"small_conv3x3: K = {k} outputs, the kernel takes "
                         f"1 to {MAX_K}")


def _check_cuda(xa, xb, w, b=None):
    bsz, ca, h, wd = xa.shape
    dev = xa.device
    build.check_tensor(xa, "small_conv3x3 xa")
    build.check_tensor(xb, "small_conv3x3 xb", (bsz, None, h, wd), dev)
    build.check_tensor(w, "small_conv3x3 w", (None, None, 3, 3), dev)
    if b is not None:
        build.check_tensor(b, "small_conv3x3 b", (w.shape[0],), dev)


def _launch_fwd(xa, xb, w, b):
    bsz, ca, h, wd = xa.shape
    cb, k = xb.shape[1], w.shape[0]
    _check_cuda(xa, xb, w, b)
    out = torch.empty((bsz, k, h, wd), device=xa.device, dtype=torch.float32)
    with torch.cuda.device(xa.device):
        lib = build.load("small_conv3x3", _SIGNATURES)
        scratch = torch.empty(lib.small_conv3x3_scratch_floats(bsz, h, wd, ca, cb, k),
                              device=xa.device, dtype=torch.float32)
        err = lib.small_conv3x3_f32(
            xa.data_ptr(), xb.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), bsz, h, wd, ca, cb, k,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "small_conv3x3")
    small_conv3x3_planar.launches += 1
    return out


def _f32(t):
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def small_conv3x3_bf16(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """K9-bf16: the forward on a bf16 xa, (B, K, H, W) bf16. On a CPU
    tensor it runs ``small_conv3x3_plain_bf16``; on a CUDA tensor it
    launches the kernel or raises. xb is cast to bf16; w and b may be f32
    or bf16 (the kernel rounds them). The kernel takes 16-byte aligned
    activations: a view that starts elsewhere is copied first."""
    if xa.device.type == "cpu":
        return small_conv3x3_plain_bf16(xa, xb, w, b)
    bsz, ca, h, wd = xa.shape
    xb = xb.to(BF16)
    cb, k = xb.shape[1], w.shape[0]
    dev = xa.device
    w, b = _f32(w), _f32(b)
    build.check_tensor(xa, "small_conv3x3_bf16 xa", dtype=BF16)
    build.check_tensor(xb, "small_conv3x3_bf16 xb", (bsz, None, h, wd), dev, dtype=BF16)
    build.check_tensor(w, "small_conv3x3_bf16 w", (None, None, 3, 3), dev)
    build.check_tensor(b, "small_conv3x3_bf16 b", (k,), dev)
    xa, xb = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xa, xb))
    out = torch.empty((bsz, k, h, wd), device=dev, dtype=BF16)
    with torch.cuda.device(dev):
        lib = build.load("small_conv3x3_bf16", _BF16_SIGNATURES)
        scratch = torch.empty(lib.small_conv3x3_bf16_scratch_floats(bsz, h, wd, ca, cb, k),
                              device=dev, dtype=torch.float32)
        err = lib.small_conv3x3_bf16(
            xa.data_ptr(), xb.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), bsz, h, wd, ca, cb, k, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "small_conv3x3_bf16")
    small_conv3x3_bf16.launches += 1
    return out


def small_conv3x3_bwd_bf16(g: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                           w: torch.Tensor):
    """K9b-bf16: (dxa, dxb) bf16 and (dw, db) f32 at cotangent ``g`` (B, K,
    H, W), rounded to bf16 first, for a bf16 xa. On a CPU tensor it runs
    ``small_conv3x3_bwd_plain_bf16``; on a CUDA tensor it launches the
    kernel or raises. The kernel takes 16-byte aligned tensors: a view that
    starts elsewhere is copied first."""
    if xa.device.type == "cpu":
        return small_conv3x3_bwd_plain_bf16(g, xa, xb, w)
    bsz, ca, h, wd = xa.shape
    g, xb, w = g.to(BF16).contiguous(), xb.to(BF16), _f32(w)
    cb, k = xb.shape[1], w.shape[0]
    dev = xa.device
    build.check_tensor(xa, "small_conv3x3_bwd_bf16 xa", dtype=BF16)
    build.check_tensor(xb, "small_conv3x3_bwd_bf16 xb", (bsz, None, h, wd), dev, dtype=BF16)
    build.check_tensor(w, "small_conv3x3_bwd_bf16 w", (None, None, 3, 3), dev)
    build.check_tensor(g, "small_conv3x3_bwd_bf16 g", (bsz, k, h, wd), dev, dtype=BF16)
    g, xa, xb = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (g, xa, xb))
    n_w = k * (ca + cb) * 9
    dxa, dxb = torch.empty_like(xa), torch.empty_like(xb)
    dwb = torch.empty(n_w + k, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        lib = build.load("small_conv3x3_bwd_bf16", _BWD_BF16_SIGNATURES)
        scratch = torch.empty(
            lib.small_conv3x3_bwd_bf16_scratch_floats(bsz, h, wd, ca, cb, k),
            device=dev, dtype=torch.float32)
        err = lib.small_conv3x3_bwd_bf16(
            g.data_ptr(), xa.data_ptr(), xb.data_ptr(), w.data_ptr(), dxa.data_ptr(),
            dxb.data_ptr(), dwb.data_ptr(), scratch.data_ptr(), bsz, h, wd, ca, cb, k,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "small_conv3x3_bwd_bf16")
    small_conv3x3_bwd_bf16.launches += 1
    return dxa, dxb, dwb[:n_w].view(w.shape), dwb[n_w:]


def small_conv3x3_bwd(g: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                      w: torch.Tensor):
    """K9b: (dxa, dxb, dw, db) at cotangent ``g`` (B, K, H, W). On a CPU
    tensor it runs ``small_conv3x3_bwd_plain``; on a CUDA tensor it launches
    the kernel or raises. A bf16 xa takes K9b-bf16 (``small_conv3x3_bwd_bf16``)."""
    if xa.dtype == BF16:
        return small_conv3x3_bwd_bf16(g, xa, xb, w)
    if xa.device.type == "cpu":
        return small_conv3x3_bwd_plain(g, xa, xb, w)
    bsz, ca, h, wd = xa.shape
    cb, k = xb.shape[1], w.shape[0]
    dev = xa.device
    _check_cuda(xa, xb, w)
    build.check_tensor(g, "small_conv3x3_bwd g", (bsz, k, h, wd), dev)
    n_w = k * (ca + cb) * 9
    dxa, dxb = torch.empty_like(xa), torch.empty_like(xb)
    dwb = torch.empty(n_w + k, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        lib = build.load("small_conv3x3_bwd", _BWD_SIGNATURES)
        scratch = torch.empty(
            lib.small_conv3x3_bwd_scratch_floats(bsz, h, wd, ca, cb, k),
            device=dev, dtype=torch.float32)
        err = lib.small_conv3x3_bwd_f32(
            g.data_ptr(), xa.data_ptr(), xb.data_ptr(), w.data_ptr(),
            dxa.data_ptr(), dxb.data_ptr(), dwb.data_ptr(), scratch.data_ptr(),
            bsz, h, wd, ca, cb, k, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "small_conv3x3_bwd")
    small_conv3x3_bwd.launches += 1
    return dxa, dxb, dwb[:n_w].view(w.shape), dwb[n_w:]


def _forward(xa, xb, w, b):
    if xa.dtype == BF16:
        return small_conv3x3_bf16(xa, xb, w, b)
    if xa.device.type == "cpu":
        return small_conv3x3_plain(xa, xb, w, b)
    return _launch_fwd(xa, xb, w, b)


class SmallConv3x3Function(torch.autograd.Function):
    """K9 forward, K9b backward, or on a bf16 xa K9-bf16 and K9b-bf16
    (their plain versions on CPU tensors). The bf16 form's f32 dW and db
    and its bf16 dxb are cast to the dtypes of w, b and xb."""

    @staticmethod
    def forward(ctx, xa, xb, w, b):
        ctx.save_for_backward(xa, xb, w)
        ctx.b_dtype = b.dtype
        return _forward(xa, xb, w, b)

    @staticmethod
    def backward(ctx, g):
        xa, xb, w = ctx.saved_tensors
        dxa, dxb, dw, db = small_conv3x3_bwd(g.contiguous(), xa, xb, w)
        return dxa, dxb.to(xb.dtype), dw.to(w.dtype), db.to(ctx.b_dtype)


def small_conv3x3_planar(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 conv (zero padding 1) over concat(xa, xb) with few
    outputs: xa (B, Ca, H, W), xb (B, Cb, H, W), w (K, Ca + Cb, 3, 3) in
    torch Conv2d layout, b (K,), K <= 32. Returns (B, K, H, W), equal to
    ``F.conv2d(torch.cat([xa, xb], 1), w, b, padding=1)``; the concat is
    never built on the card. On a bf16 xa the result is bf16 and rounded
    per tap as the TPU kernel rounds (``small_conv3x3_bf16``)."""
    _check_args(xa, xb, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xa, xb, w, b)):
        return SmallConv3x3Function.apply(xa, xb, w, b)
    return _forward(xa, xb, w, b)


small_conv3x3_planar.launches = 0
small_conv3x3_bwd.launches = 0
small_conv3x3_bf16.launches = 0
small_conv3x3_bwd_bf16.launches = 0

HEADS_CA, HEADS_CB = 192, 64   # the heads' stage 2: three 64-wide heads, fe1

# ---- K9's design, mirrored for the CPU tests ----
# (csrc/small_conv3x3.cu: the block tiles, the channel splits, shared memory)
FWD_THREADS, FWD_MIN_BLOCKS = 256, 2   # two warpgroups, two blocks an SM
FWD_TC, FWD_RP, FWD_CH = 32, 40, 8     # tile columns; floats a staged row; channels a chunk
FWD_STAGES, FWD_MAX_SPLIT = 3, 8


def _fwd_plane_floats(rows):
    return rows * FWD_RP + ((8 - rows * FWD_RP % 16) + 16) % 16


def fwd_plan(b: int, h: int, w: int, ca: int, cb: int, k: int, sms: int = 132):
    """K9's launches as ``csrc/small_conv3x3.cu`` plans them: ``n`` = K
    rounded up to 8 (wgmma's N), ``mt`` M-tiles of 64 pixels (4 rows x 16
    columns) a warpgroup, a block tile of ``tile`` = (8 mt / 2, 32) pixels,
    ``chunks`` of 8 channels split over ``splits`` blocks a tile of
    ``chunks_per`` each (the split with the fewest chunk-steps, plus two of
    pipeline fill, over its waves of 2 blocks an SM), ``grid`` (x, y, b
    splits), ``smem`` bytes a block (three stages of a chunk's x tile with
    its halo and its split weights) and ``scratch`` floats (the split
    weights, and the partial sums where there are splits)."""
    n = -(-k // 8) * 8
    mt = 4 if n <= 16 else 2
    tr = 8 * mt // 2
    tiles = b * -(-h // tr) * -(-w // FWD_TC)
    chunks = -(-(ca + cb) // FWD_CH)
    slots = FWD_MIN_BLOCKS * sms
    best = None
    for ns in range(1, min(FWD_MAX_SPLIT, chunks) + 1):
        per = -(-chunks // ns)
        splits = -(-chunks // per)
        cost = -(-tiles * splits // slots) * (per + 2)
        if best is None or cost < best[0]:
            best = (cost, per, splits)
    _, per, splits = best
    weights = chunks * 9 * 16 * n
    return {"n": n, "mt": mt, "tile": (tr, FWD_TC), "tiles": tiles, "chunks": chunks,
            "chunks_per": per, "splits": splits,
            "grid": (-(-w // FWD_TC), -(-h // tr), b * splits),
            "smem": FWD_STAGES * (FWD_CH * _fwd_plane_floats(tr + 2) + 9 * 2 * 8 * n) * 4,
            "scratch": weights + (splits * b * k * h * w if splits > 1 else 0),
            "threads": FWD_THREADS, "regs": 65536 // (FWD_THREADS * FWD_MIN_BLOCKS)}


def small_conv3x3_split_plain(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, sms: int = 132, passes: int = 3) -> torch.Tensor:
    """K9's arithmetic emulated in float32 on the CPU, in the kernel's
    order (tests only): per split of ``fwd_plan``, starting from the bias
    (the first split) or zero, each chunk of 8 channels summed apart over
    its 9 taps, a k-step a tap of 3xTF32 products (``passes`` as
    ``_mma_3x``), then added to the split's sum; the splits added in
    order. Returns (B, K, H, W)."""
    bsz, ca, h, wd = xa.shape
    k = w.shape[0]
    c = ca + xb.shape[1]
    plan = fwd_plan(bsz, h, wd, ca, xb.shape[1], k, sms)
    n, cp = plan["n"], plan["chunks"] * FWD_CH
    xp = F.pad(torch.cat([xa, xb], 1).float(), (1, 1, 1, 1, 0, cp - c))
    wm = F.pad(w.float(), (0, 0, 0, 0, 0, cp - c, 0, n - k))          # (n, cp, 3, 3)
    cols = [xp[:, :, ty:ty + h, tx:tx + wd].permute(0, 2, 3, 1).reshape(-1, cp)
            for ty in range(3) for tx in range(3)]                     # per tap (P, cp)
    total = None
    for s in range(plan["splits"]):
        part = torch.zeros(cols[0].shape[0], n)
        if s == 0:
            part = part + F.pad(b.float(), (0, n - k))
        for ch in range(s * plan["chunks_per"],
                        min((s + 1) * plan["chunks_per"], plan["chunks"])):
            sl = slice(FWD_CH * ch, FWD_CH * ch + FWD_CH)
            acc = torch.zeros_like(part)
            for tap in range(9):
                acc = _mma_3x(acc, cols[tap][:, sl], wm[:, sl, tap // 3, tap % 3].t(), passes)
            part = part + acc
        total = part if total is None else total + part
    return total[:, :k].reshape(bsz, h, wd, k).permute(0, 3, 1, 2).contiguous()


# ---- K9b's design, mirrored for the CPU tests ----
# (csrc/small_conv3x3_bwd.cu: dx_kernel's and wgrad_kernel's tiles and
# launches, and the reduction's slices)
CARD_SMS = 132                  # H100 SXM
CARD_SMEM = 233472              # shared memory of an SM
BLOCK_SMEM_MAX = 232448         # that a block may use
BWD_THREADS, BWD_MIN_BLOCKS = 256, 2   # both passes: two warpgroups, two blocks an SM
DX_TILE, DX_PS = (8, 16), 184   # dx's pixel tile; floats a staged g plane
WG_TILE, WG_MR, WG_NC = (4, 16), 128, 64   # dW's tile; (tap, k) rows and channels a block
WG_STAGES, WG_PS = 3, 164       # dW's tiles in flight; floats a staged g plane
RED_CHUNK = 64                  # bwd_common.cuh: slices one reduce pass adds


def _tiles(b, h, w, tile):
    return b * -(-h // tile[0]) * -(-w // tile[1])


def _dx_smem(nc, k, nks):
    return 2 * nks * 8 * nc * 4 + 2 * k * DX_PS * 4 + nks * 8 * 4


def bwd_plan(b: int, h: int, w: int, ca: int, cb: int, k: int, sms: int = CARD_SMS):
    """K9b's launches as ``csrc/small_conv3x3_bwd.cu`` plans them.

    dx: grid (``dx_chunks`` of ``dx_nc`` channels, ``dx_blocks`` persistent
    blocks), block j of a chunk walking the 8x16 pixel tiles j, j +
    dx_blocks, ...; ``dx_nc`` is 128 where two such blocks fit an SM, else
    64; ``dx_smem`` bytes (the chunk's weights split into TF32 heads and
    rests, two buffers of g's K planes with their halo, the (tap, k)
    offsets). dW: grid (``mchunks`` of 128 (tap, k) rows x ``cchunks`` of
    64 channels, ``slices``), slice s summing the 4x16 tiles [T s / S,
    T (s + 1) / S); ``wg_smem`` bytes (three x tiles in flight, the rests
    of the one in use, three buffers of g). Both kernels run 256 threads,
    at most 128 registers a thread (two blocks an SM)."""
    c, nks = ca + cb, -(-9 * k // 8)
    dx_nc = 128 if 2 * (_dx_smem(128, k, nks) + 1024) <= CARD_SMEM else 64
    dx_smem = _dx_smem(dx_nc, k, nks)
    dx_per_sm = 2 if 2 * (dx_smem + 1024) <= CARD_SMEM else 1
    dx_tiles = _tiles(b, h, w, DX_TILE)
    dx_chunks = -(-c // dx_nc)
    mchunks, cchunks = -(-9 * k // WG_MR), -(-c // WG_NC)
    wg_tiles = _tiles(b, h, w, WG_TILE)
    return {"ksteps": nks, "dx_nc": dx_nc, "dx_chunks": dx_chunks, "dx_tiles": dx_tiles,
            "dx_blocks": max(1, min(dx_tiles, dx_per_sm * sms // dx_chunks)),
            "dx_smem": dx_smem, "dx_per_sm": dx_per_sm, "mchunks": mchunks,
            "cchunks": cchunks, "wg_tiles": wg_tiles,
            "slices": max(1, min(wg_tiles, BWD_MIN_BLOCKS * sms // (mchunks * cchunks),
                                 RED_CHUNK)),
            "wg_smem": ((WG_STAGES + 1) * WG_NC * WG_TILE[0] * WG_TILE[1]
                        + WG_STAGES * k * WG_PS + k * WG_TILE[0]) * 4,
            "threads": BWD_THREADS, "regs": 65536 // (BWD_THREADS * BWD_MIN_BLOCKS)}


def _tf32_split(v: torch.Tensor):
    """(hi, lo): v's TF32 head, its low 13 bits cleared (truncated), and the
    exact rest, truncated to TF32 too, as the kernel splits its operands."""
    def trunc(t):
        return (t.view(torch.int32) & -8192).view(torch.float32)
    hi = trunc(v.float().contiguous())
    return hi, trunc((v.float() - hi).contiguous())


def _mma_3x(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """d + a . b as the kernel's three products of a k-step sum it: lo.hi,
    hi.lo, hi.hi, each pass's products summed exactly and added to d in f32
    (rounded to nearest here; the card's tensor cores truncate). With
    ``passes=1``, hi.hi alone."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    for x, y in ((al, bh), (ah, bl), (ah, bh))[3 - passes:]:
        d = (d.double() + torch.matmul(x.double(), y.double())).float()
    return d


def _shifted_g(g: torch.Tensor, k_pad: int) -> torch.Tensor:
    """G (B, H, W, 9K padded to k_pad): G[..., tap * K + k] = g_k[y - ty + 1,
    x - tx + 1], zero outside the image: the mirrored-tap im2col."""
    bsz, k, h, w = g.shape
    gp = F.pad(g, (1, 1, 1, 1))
    cols = [gp[:, :, 2 - ty:2 - ty + h, 2 - tx:2 - tx + w]
            for ty in range(3) for tx in range(3)]
    out = torch.stack(cols, 1).reshape(bsz, 9 * k, h, w).permute(0, 2, 3, 1)
    return F.pad(out, (0, k_pad - 9 * k))


def _reduce_partials(part: torch.Tensor) -> torch.Tensor:
    """bwd::reduce_partials' order for at most 64 slices: strand t adds
    slices t, t + 8, ... in order, then the 8 strands are added in order."""
    strands = []
    for t in range(8):
        v = torch.zeros_like(part[0])
        for s in range(t, part.shape[0], 8):
            v = v + part[s]
        strands.append(v)
    out = strands[0]
    for v in strands[1:]:
        out = out + v
    return out


def small_conv3x3_bwd_split_plain(g: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                                  w: torch.Tensor, sms: int = CARD_SMS, passes: int = 3):
    """K9b's arithmetic emulated in float32 on the CPU, in the kernel's
    order (tests only): the 3xTF32 products of each k-step of 8 (``passes``
    as ``_mma_3x``), dx over the (tap, k) rows in order; dW per slice of
    ``bwd_plan``, each 4x16 tile's 8 k-steps of 8 pixels summed apart and
    then added to the slice's sum, the slices added as ``reduce_partials``
    does; db likewise, a thread's row of 16 pixels a tile. Returns (dxa,
    dxb, dw, db)."""
    bsz, ca, h, wd = xa.shape
    cb, k = xb.shape[1], w.shape[0]
    c = ca + cb
    plan = bwd_plan(bsz, h, wd, ca, cb, k, sms)
    kp = 8 * plan["ksteps"]
    gm = _shifted_g(g.float(), kp)                            # (B, H, W, kp)
    wm = F.pad(w.float().permute(2, 3, 0, 1).reshape(9 * k, c), (0, 0, 0, kp - 9 * k))
    # dx: (pixels x kp) . (kp x C), k-step by k-step
    a = gm.reshape(-1, kp)
    d = torch.zeros(a.shape[0], c)
    for s in range(plan["ksteps"]):
        d = _mma_3x(d, a[:, 8 * s:8 * s + 8], wm[8 * s:8 * s + 8], passes)
    dx = d.reshape(bsz, h, wd, c).permute(0, 3, 1, 2)
    # dW: the 4x16 tiles (padded image), 8 k-steps of 8 pixels each
    th, tw = WG_TILE
    hp, wp = -(-h // th) * th, -(-wd // tw) * tw
    x = F.pad(torch.cat([xa, xb], 1).float(), (0, wp - wd, 0, hp - h))
    gt = _shifted_g(F.pad(g.float(), (0, wp - wd, 0, hp - h)), 9 * k)   # (B, hp, wp, 9K)
    gt = gt.reshape(bsz, hp // th, th, wp // tw, tw, 9 * k).permute(0, 1, 3, 2, 4, 5)
    gt = gt.reshape(-1, th * tw, 9 * k)                       # (T, 64 pixels, 9K)
    xt = x.reshape(bsz, c, hp // th, th, wp // tw, tw).permute(0, 2, 4, 3, 5, 1)
    xt = xt.reshape(-1, th * tw, c)                           # (T, 64, C)
    acc = torch.zeros(gt.shape[0], 9 * k, c)
    for q in range(th * tw // 8):
        acc = _mma_3x(acc, gt[:, 8 * q:8 * q + 8].transpose(1, 2), xt[:, 8 * q:8 * q + 8],
                      passes)
    # db: thread (k, row) adds its row's 16 pixels a tile, in order
    gpad = F.pad(g.float(), (0, wp - wd, 0, hp - h))
    gpad = gpad.reshape(bsz, k, hp // th, th, wp // tw, tw).permute(0, 2, 4, 1, 3, 5)
    gpad = gpad.reshape(-1, k, th, tw)                        # (T, K, rows, 16)
    n_t, n_s = acc.shape[0], plan["slices"]
    parts = []
    for s in range(n_s):
        t0, t1 = n_t * s // n_s, n_t * (s + 1) // n_s
        total, dbrow = torch.zeros(9 * k, c), torch.zeros(k, th)
        for t in range(t0, t1):
            total = total + acc[t]
            for col in range(tw):
                dbrow = dbrow + gpad[t, :, :, col]
        db = dbrow[:, 0]
        for r in range(1, th):
            db = db + dbrow[:, r]
        dw = total.reshape(3, 3, k, c).permute(2, 3, 0, 1)    # (K, C, 3, 3)
        parts.append(torch.cat([dw.reshape(-1), db]))
    dwb = _reduce_partials(torch.stack(parts))
    n_w = k * c * 9
    return (dx[:, :ca].contiguous(), dx[:, ca:].contiguous(),
            dwb[:n_w].view(k, c, 3, 3), dwb[n_w:])


def _case_tensors(gen, device, b, h, w, k, ca, cb):
    rng = case_rng(gen)

    def randn(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std)
                                .astype("float32")).to(device)

    return (randn(b, ca, h, w), randn(b, cb, h, w),
            randn(k, ca + cb, 3, 3, std=(9 * (ca + cb)) ** -0.5), randn(k, std=0.1),
            randn(b, k, h, w))


def small_conv3x3_case(gen: torch.Generator, device, b: int, h: int, w: int,
                       k: int = 10, ca: int = HEADS_CA, cb: int = HEADS_CB,
                       dtype: torch.dtype = torch.float32):
    """Inputs on which K9 (K9-bf16 with ``dtype`` bf16) is timed on the
    card, from ``gen``: N(0, 1) activations (b, ca, h, w) and (b, cb, h, w)
    in ``dtype``, an f32 weight scaled to unit output variance and an f32
    bias (the port's bf16 models keep f32 parameters). Returns ((xa, xb, w,
    bias), library): the library call is ``F.conv2d`` over the concat (the
    f32 plain version; in bf16 cuDNN's bf16 conv, its weights rounded
    beforehand)."""
    xa, xb, wk, bk, _ = _case_tensors(gen, device, b, h, w, k, ca, cb)
    if dtype == BF16:
        xa, xb = xa.to(BF16), xb.to(BF16)
        wl, bl = wk.to(BF16), bk.to(BF16)
        return (xa, xb, wk, bk), lambda: F.conv2d(torch.cat([xa, xb], 1), wl, bl, padding=1)
    return (xa, xb, wk, bk), lambda: small_conv3x3_plain(xa, xb, wk, bk)


def small_conv3x3_bwd_case(gen: torch.Generator, device, b: int, h: int, w: int,
                           k: int = 10, ca: int = HEADS_CA, cb: int = HEADS_CB,
                           dtype: torch.dtype = torch.float32):
    """Inputs on which K9b (K9b-bf16 with ``dtype`` bf16) is timed on the
    card, from ``gen``, as ``small_conv3x3_case``'s with an N(0, 1)
    cotangent g (b, k, h, w) in ``dtype``. Returns ((g, xa, xb, w),
    library): the library call is cuDNN's backward of the concat conv
    (``aten.convolution_backward``, what autograd runs for it; the concat
    is built beforehand, its backward is two views), in bf16 with the
    weights rounded beforehand."""
    xa, xb, wk, _, g = _case_tensors(gen, device, b, h, w, k, ca, cb)
    if dtype == BF16:
        xa, xb, g = xa.to(BF16), xb.to(BF16), g.to(BF16)
    xcat = torch.cat([xa, xb], 1)
    wl = wk.to(dtype)

    def library():
        dx, dw, db = torch.ops.aten.convolution_backward(
            g, xcat, wl, [k], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, True])
        return dx[:, :ca], dx[:, ca:], dw, db

    return (g, xa, xb, wk), library


# ---- K9-bf16's and K9b-bf16's designs, mirrored for the CPU tests ----
# (csrc/small_conv3x3_bf16.cu and csrc/small_conv3x3_bwd_bf16.cu)
BF_TILE = (4, 32)              # K9-bf16's block tile: a warpgroup 4 rows x 16 columns
BF_CH, BF_RP, BF_PS = 16, 48, 296   # channels a chunk; bf16 a staged row, a plane
BF_STAGES = 3
BWD_BF_TILE = (2, 64)          # K9b-bf16's pixel tile, both passes
BWD_BF_GW, BWD_BF_GP = 88, 440  # bf16 a row and a plane (5 rows) of g's staged box
BWD_BF_RPS, BWD_BF_PSS = 64, 264   # the same of g's copies shifted by one column
BWD_BF_ZEROS = 144             # bf16 of zeros that padding rows of the 9K side read
BWD_BF_OCP = 2 * 64 + 8        # bf16 a channel of dx's staging tile
BWD_BF_MAX_SLICES = 64         # dW's slices at most


_BF_PLAN_KEYS = ("n", "tiles_x", "tiles_y", "pitch", "threads", "smem", "min_blocks", "chunks")


def fwd_plan_bf16(b: int, h: int, w: int, ca: int, cb: int, k: int):
    """K9-bf16's launch as ``csrc/small_conv3x3_bf16.cu`` plans it: ``n`` =
    K rounded up to 8 (wgmma's N), nine accumulators of n/2 floats a thread
    (one a tap), a block tile of ``tile`` pixels and its one-pixel halo over
    a ``grid`` of tiles (columns, rows, batch), ``chunks`` of 16 channels (a
    k-step a tap) in three stages of ``smem`` bytes (the x tile as raw bf16
    in planes of ``BF_PS``, its rows columns x0 - 8 .. x0 + 39 in 16-byte
    pieces, and the chunk's weights), no splits. The kernel reads x in rows
    of ``pitch`` bf16: W, or, where W % 8 != 0 (``padded``), a copy of x
    with its rows zero-padded to a multiple of 8 columns. ``scratch`` floats
    hold the rounded weights and that copy; ``min_blocks`` blocks an SM (one
    where 144 accumulators would not leave two); ``batch`` taps' A
    fragments are built and issued at once."""
    n = -(-k // 8) * 8
    chunks = -(-(ca + cb) // BF_CH)
    pitch = -(-w // 8) * 8
    weights = chunks * 9 * 16 * n // 2
    return {"n": n, "tile": BF_TILE, "grid": (-(-w // BF_TILE[1]), -(-h // BF_TILE[0]), b),
            "chunks": chunks, "accumulators": 9 * n // 2,
            "smem": BF_STAGES * (BF_CH * BF_PS + 9 * 16 * n) * 2, "pitch": pitch,
            "padded": pitch != w,
            "scratch": weights + (-(-b * (ca + cb) * h * pitch // 2) if pitch != w else 0),
            "threads": 256, "min_blocks": 2 if n <= 16 else 1, "batch": 5 if n == 16 else 9,
            "regs": min(255, 65536 // (256 * (2 if n <= 16 else 1)))}


def fwd_plan_bf16_card(b: int, h: int, w: int, ca: int, cb: int, k: int):
    """The same plan as the built kernel reports it
    (``small_conv3x3_bf16_plan``), in ``fwd_plan_bf16``'s keys, for
    ``chip_smoke.py`` to hold against it."""
    lib = build.load("small_conv3x3_bf16", _BF16_SIGNATURES)
    out = (ctypes.c_int * 8)()
    build.check_launch(lib.small_conv3x3_bf16_plan(h, w, ca + cb, k, out),
                       "small_conv3x3_bf16_plan")
    p = dict(zip(_BF_PLAN_KEYS, out))
    return {"n": p["n"], "grid": (p["tiles_x"], p["tiles_y"], b), "pitch": p["pitch"],
            "threads": p["threads"], "smem": p["smem"], "min_blocks": p["min_blocks"],
            "chunks": p["chunks"]}


def small_conv3x3_bf16_chunks_plain(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                                    b: torch.Tensor) -> torch.Tensor:
    """K9-bf16's arithmetic in the kernel's order, on the CPU: x, the
    weights and the bias rounded to bf16; each tap's f32 sum taken chunk
    by chunk of 16 channels in order (a chunk's product added to the
    tap's accumulator), rounded to bf16; the nine rounded taps added in tap
    order, then the rounded bias, and rounded once more. Returns (B, K, H,
    W) bf16."""
    bsz, _, h, wd = xa.shape
    k = w.shape[0]
    x = torch.cat([xa.to(BF16), xb.to(BF16)], 1).float()
    c = x.shape[1]
    xp = F.pad(x, (1, 1, 1, 1))
    wr = w.to(BF16).float()
    total = None
    for tap in range(9):
        ty, tx = divmod(tap, 3)
        cols = xp[:, :, ty:ty + h, tx:tx + wd].permute(0, 2, 3, 1).reshape(-1, c)
        acc = torch.zeros(cols.shape[0], k)
        for ch in range(0, c, BF_CH):
            acc = acc + cols[:, ch:ch + BF_CH] @ wr[:, ch:ch + BF_CH, ty, tx].t()
        t = acc.to(BF16).float()
        total = t if total is None else total + t
    out = (total + b.to(BF16).float()).to(BF16)
    return out.reshape(bsz, h, wd, k).permute(0, 3, 1, 2).contiguous()


def bwd_plan_bf16(b: int, h: int, w: int, ca: int, cb: int, k: int, sms: int = CARD_SMS):
    """K9b-bf16's launches as ``csrc/small_conv3x3_bwd_bf16.cu`` plans them.
    Both passes walk ``tiles`` 2x64 pixel tiles (``tiles_x`` x ``tiles_y``
    an image) and read x and g by tensor copies in rows of ``pitch`` bf16:
    W, or W rounded up to 8 in copies of x and g made first (``copied``:
    where W % 8 != 0, and where dW's blocks of 64 channels would straddle
    xa and xb, x as one concat). dx: grid (``dx_chunks`` of ``dx_nc``
    channels, ``dx_blocks`` persistent blocks), block j of a chunk walking
    tiles j, j + dx_blocks, ...; ``dx_nc`` is 128 where two such blocks fit
    an SM, else 64; ``dx_smem`` bytes (1024 to align, the chunk's rounded
    weights, ``ksteps`` k-steps of 16 (tap, k) rows; ``dx_stages`` stages of
    g, a tensor copy each, and its copies shifted by one column either way,
    which dx's staging tile replaces once the products have read them; the
    rows' offsets). dW: grid (``mchunks`` of 128 (tap, k) rows x
    ``cchunks`` of 64 channels, ``slices``), slice s summing tiles s, s + S,
    s + 2 S, ..., ``wg_smem`` bytes (``wg_stages`` stages of x and g, g's
    shifted copies, db's partial sums). Each pass takes the most stages (4, 3, 2) with which two blocks fit an
    SM (else, one block, the most that fit). ``side``: dW runs on a second
    stream beside dx, where each dx block walks at most 8 tiles. ``scratch``
    floats: the rounded weights, the copies of x and g, the slices' partial
    sums."""
    c, nks = ca + cb, -(-9 * k // 16)
    pitch = -(-w // 8) * 8
    copied = pitch != w or ca == 0 or (cb > 0 and ca % WG_NC != 0)
    tiles_x, tiles_y = -(-w // BWD_BF_TILE[1]), -(-h // BWD_BF_TILE[0])
    tiles = b * tiles_x * tiles_y

    def up(n, m):
        return -(-n // m) * m

    g_stage = up(k * BWD_BF_GP, 64)
    g_shifted = up(2 * k * BWD_BF_PSS + BWD_BF_ZEROS, 64)
    wg_stage = up(WG_NC * 128 + g_stage, 512)

    def dx_smem(nc, stages):
        return (1024 + (nks * 16 * nc + stages * g_stage + max(g_shifted, nc * BWD_BF_OCP)) * 2
                + nks * 16 * 4)

    def wg_smem(stages):
        return 1024 + (stages * wg_stage + g_shifted) * 2 + k * 16 * 4

    def fits2(smem):
        return 2 * (smem + 1024) <= CARD_SMEM

    def most_stages(smem_of):
        return next((st for st in (4, 3, 2) if fits2(smem_of(st))),
                    next((st for st in (4, 3) if smem_of(st) <= BLOCK_SMEM_MAX), 2))

    dx_nc = 128 if fits2(dx_smem(128, 2)) else 64
    dx_stages = most_stages(lambda st: dx_smem(dx_nc, st))
    dx_per_sm = 2 if fits2(dx_smem(dx_nc, dx_stages)) else 1
    dx_chunks = -(-c // dx_nc)
    mchunks, cchunks = -(-9 * k // WG_MR), -(-c // WG_NC)
    wg_stages = most_stages(wg_smem)
    wg_per_sm = 2 if fits2(wg_smem(wg_stages)) else 1
    slices = max(1, min(tiles, wg_per_sm * sms // (mchunks * cchunks), BWD_BF_MAX_SLICES))

    scratch = (up(dx_chunks * nks * 16 * dx_nc // 2, 4)
               + (up(-(-b * c * h * pitch // 2), 4) + up(-(-b * k * h * pitch // 2), 4)
                  if copied else 0)
               + up(slices * (9 * k * c + k), 4))
    dx_blocks = max(1, min(tiles, dx_per_sm * sms // dx_chunks))
    return {"pitch": pitch, "copied": int(copied), "ksteps": nks, "tiles_x": tiles_x,
            "tiles_y": tiles_y, "tiles": tiles, "dx_nc": dx_nc, "dx_chunks": dx_chunks,
            "dx_blocks": dx_blocks, "side": int(tiles <= 8 * dx_blocks),
            "dx_smem": dx_smem(dx_nc, dx_stages), "dx_per_sm": dx_per_sm,
            "dx_stages": dx_stages, "mchunks": mchunks, "cchunks": cchunks, "slices": slices,
            "wg_smem": wg_smem(wg_stages), "wg_per_sm": wg_per_sm, "wg_stages": wg_stages,
            "scratch": scratch, "threads": BWD_THREADS,
            "regs": 65536 // (BWD_THREADS * BWD_MIN_BLOCKS)}


_BWD_BF_PLAN_KEYS = ("pitch", "copied", "ksteps", "tiles_x", "tiles_y", "dx_nc", "dx_chunks",
                     "dx_blocks", "dx_smem", "dx_per_sm", "dx_stages", "mchunks", "cchunks",
                     "slices", "wg_smem", "wg_per_sm", "wg_stages", "side")


def bwd_plan_bf16_card(b: int, h: int, w: int, ca: int, cb: int, k: int):
    """The same plan as the built kernel reports it on the current card
    (``small_conv3x3_bwd_bf16_plan``), in ``bwd_plan_bf16``'s keys, for
    ``chip_smoke.py`` to hold against it."""
    lib = build.load("small_conv3x3_bwd_bf16", _BWD_BF16_SIGNATURES)
    out = (ctypes.c_int * len(_BWD_BF_PLAN_KEYS))()
    build.check_launch(lib.small_conv3x3_bwd_bf16_plan(b, h, w, ca, cb, k, out),
                       "small_conv3x3_bwd_bf16_plan")
    return dict(zip(_BWD_BF_PLAN_KEYS, out))


def pad_rows_bf16(t: torch.Tensor, pitch: int) -> torch.Tensor:
    """K9b-bf16's copy of x or g (``pad_rows_kernel``) on the CPU: t (...,
    H, W) with its rows zero-padded to ``pitch`` columns."""
    return F.pad(t, (0, pitch - t.shape[-1]))
