"""Kernel K10a: the windowed form of the deformable gather, and the
differentiable drop-in built on it.

Counterpart of the JAX package's ``devtools/exp_deform_prop_kernel.py``:
K10a (``csrc/deform_windowed.cu``) replaces its TPU kernel
``_windowed_kernel`` (reached from ``_deform_pallas_core``). It computes

    out(y, x) = sum_k aff_k * sum_{u, v in [-R, R+1]} tent(oy_k - u)
                * tent(ox_k - v) * P(y + dy_k + u, x + dx_k + v)

on the zero-padded plane: the exact bilinear gather when every offset lies
in [-R, R], truncated by the window beyond. No conf, blend or clip. Its
plain version is ``ops.propagate.propagate_deformable_windowed_planar``, in
the same order of operations.

The backward is K8 (``ops.kernels.deform_prop.deform_prop_bwd`` without
conf, dep, blend or clip): the VJP of the windowed form that the JAX
prototype's ``_deform_op_bwd`` differentiates, with its tie rules, for any
offset (the window truncates the gradient as it truncates the value). On
CPU tensors it is ``deform_prop_bwd_plain``.

The JAX module's ``deform_pallas_available`` and ``deform_kernel_supported``
route around the TPU's VMEM budget and have no counterpart: K10a tiles the
plane, so it takes any height and width; its one limit is the window,
radius 0 to 8 (the column tents live in registers), and the wrapper raises
beyond it.
"""

from __future__ import annotations

import ctypes

import torch

from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import deform_prop_bwd
from nlspn_eccv20_tpu_torch.ops.propagate import (
    _check_deformable,
    propagate_deformable_windowed_planar,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"deform_windowed_f32": [_P] * 4 + [_I] * 5 + [_P]}
MAX_RADIUS = 8


def deform_windowed(feat: torch.Tensor, off: torch.Tensor, aff: torch.Tensor,
                    kernel: int = 3, radius: int = 4) -> torch.Tensor:
    """K10a: feat (B, H, W), off (B, 2 K2, H, W) with the (dy, dx) pair of
    neighbour k at channels (2k, 2k + 1), aff (B, K2, H, W) -> (B, H, W).
    On a CPU tensor it runs the plain version; on a CUDA tensor it launches
    the kernel or raises."""
    _check_deformable(off, aff, kernel)
    if feat.device.type == "cpu":
        return propagate_deformable_windowed_planar(feat, off, aff, kernel, radius)
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"deform_windowed: radius {radius} outside [0, {MAX_RADIUS}]")
    b, h, w = feat.shape
    k2 = kernel * kernel
    build.check_tensor(feat, "deform_windowed feat")
    build.check_tensor(off, "deform_windowed off", (b, 2 * k2, h, w), feat.device)
    build.check_tensor(aff, "deform_windowed aff", (b, k2, h, w), feat.device)
    out = torch.empty_like(feat)
    with torch.cuda.device(feat.device):
        lib = build.load("deform_windowed", _SIGNATURES)
        err = lib.deform_windowed_f32(
            feat.data_ptr(), off.data_ptr(), aff.data_ptr(), out.data_ptr(),
            b, h, w, kernel // 2, radius, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "deform_windowed")
    deform_windowed.launches += 1
    return out


deform_windowed.launches = 0


class DeformWindowedFunction(torch.autograd.Function):
    """K10a forward, K8 backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, feat, off, aff, kernel, radius):
        ctx.kernel, ctx.radius = kernel, radius
        ctx.save_for_backward(feat, off, aff)
        return deform_windowed(feat, off, aff, kernel, radius)

    @staticmethod
    def backward(ctx, g):
        feat, off, aff = ctx.saved_tensors
        d_feat, d_off, d_aff, _ = deform_prop_bwd(
            g.contiguous(), feat, off, aff, kernel=ctx.kernel, radius=ctx.radius)
        return d_feat, d_off, d_aff, None, None


def propagate_deformable_pallas(feat: torch.Tensor, offset: torch.Tensor,
                                aff: torch.Tensor, kernel: int = 3,
                                radius: int = 4) -> torch.Tensor:
    """The JAX prototype's drop-in for the windowed form, on the port's
    layout: feat (B, 1, H, W), offset (B, 2 K2, H, W), aff (B, K2, H, W)
    -> (B, 1, H, W). K10a forward; under autograd, K8 backward. Exact when
    every offset lies in [-radius, radius]."""
    if feat.shape[1] != 1:
        raise ValueError(f"feat has {feat.shape[1]} channels, want 1")
    f, off, a = feat[:, 0].contiguous(), offset.contiguous(), aff.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (f, off, a)):
        return DeformWindowedFunction.apply(f, off, a, kernel, radius)[:, None]
    return deform_windowed(f, off, a, kernel, radius)[:, None]
