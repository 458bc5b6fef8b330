"""Kernel K9: a 3x3 stride-1 convolution of concat(xa, xb) with few outputs,
planar in and out, and its backward K9b.

K9 replaces the TPU kernel ``small_conv3x3._fwd_kernel`` (reached from
``_fwd_pallas``, ``nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py``); CUDA
source ``csrc/small_conv3x3.cu``. K9b replaces its backward
(``_bwd_kernel``, reached from ``_bwd_pallas``); CUDA source
``csrc/small_conv3x3_bwd.cu``. Each source's header says what bounds it on
the card and how it is laid out.

The op was built for the heads' stage-2 conv (the JAX package's
``models/nlspn.Heads``): xa the three heads' stage-1 outputs, xb ``fe1``,
K = 1 + num_neighbors + 1 outputs (3 num_neighbors + 2 with ``offset``).
Neither model routes through it; it is an op-library primitive, and
``fuse_heads_dec0`` builds the fused stage-2 weights it takes there.

``small_conv3x3_planar`` is differentiable: under autograd it runs
``SmallConv3x3Function``, whose backward is K9b on a CUDA tensor and
``small_conv3x3_bwd_plain`` on a CPU tensor. float32 only: bf16 is ROADMAP
§A's bf16 item, for every kernel at once.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "small_conv3x3_f32": [_P] * 6 + [_I] * 6 + [_P],
    "small_conv3x3_scratch_floats": ([_I] * 6, ctypes.c_longlong),
}
_BWD_SIGNATURES = {
    "small_conv3x3_bwd_f32": [_P] * 8 + [_I] * 6 + [_P],
    "small_conv3x3_bwd_scratch_floats": ([_I] * 6, ctypes.c_longlong),
}
MAX_K = 32                 # outputs the kernels' register tiles hold


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
    for t in (xa, xb, w, b):
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(
                "small_conv3x3_planar: bf16 is not ported yet (ROADMAP.md §A, "
                "the bf16 item); pass float32")
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


def small_conv3x3_bwd(g: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                      w: torch.Tensor):
    """K9b: (dxa, dxb, dw, db) at cotangent ``g`` (B, K, H, W). On a CPU
    tensor it runs ``small_conv3x3_bwd_plain``; on a CUDA tensor it launches
    the kernel or raises."""
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


class SmallConv3x3Function(torch.autograd.Function):
    """K9 forward, K9b backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, xa, xb, w, b):
        ctx.save_for_backward(xa, xb, w)
        if xa.device.type == "cpu":
            return small_conv3x3_plain(xa, xb, w, b)
        return _launch_fwd(xa, xb, w, b)

    @staticmethod
    def backward(ctx, g):
        return small_conv3x3_bwd(g.contiguous(), *ctx.saved_tensors)


def small_conv3x3_planar(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 conv (zero padding 1) over concat(xa, xb) with few
    outputs: xa (B, Ca, H, W), xb (B, Cb, H, W), w (K, Ca + Cb, 3, 3) in
    torch Conv2d layout, b (K,), K <= 32. Returns (B, K, H, W), equal to
    ``F.conv2d(torch.cat([xa, xb], 1), w, b, padding=1)``; the concat is
    never built on the card. float32; bf16 raises."""
    _check_args(xa, xb, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xa, xb, w, b)):
        return SmallConv3x3Function.apply(xa, xb, w, b)
    if xa.device.type == "cpu":
        return small_conv3x3_plain(xa, xb, w, b)
    return _launch_fwd(xa, xb, w, b)


small_conv3x3_planar.launches = 0
small_conv3x3_bwd.launches = 0
