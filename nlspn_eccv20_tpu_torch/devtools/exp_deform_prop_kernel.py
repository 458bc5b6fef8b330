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

The tent is non-zero on at most two rows and two columns of the window,
so the kernel sums only those 2 x 2 cells a neighbour, each where it lies
in the window, in the plain version's order and with its weight
expression: the same bits for any finite plane and finite offsets
(``deform_windowed_two_taps`` is that arithmetic in PyTorch, for the CPU
tests; ``windowed_map`` mirrors its pixel-to-thread map: 2 pixels a
thread, a warp's width apart, so that a warp reads neighbouring columns).
``deform_windowed_case`` builds the experiment's kind of inputs from a
seeded generator for ``tools/profile_kernels.py``.

The JAX module's ``deform_pallas_available`` and ``deform_kernel_supported``
route around the TPU's VMEM budget and have no counterpart: K10a tiles the
plane, so it takes any height and width; its one limit is the window,
radius 0 to 8, and the wrapper raises beyond it.
"""

from __future__ import annotations

import ctypes

import torch

from nlspn_eccv20_tpu_torch.devtools.exp_deform3 import RADIUS, experiment_case
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import deform_prop_bwd
from nlspn_eccv20_tpu_torch.ops.propagate import (
    _check_deformable,
    neighbor_shifts,
    propagate_deformable_windowed_planar,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"deform_windowed_f32": [_P] * 4 + [_I] * 5 + [_P]}
MAX_RADIUS = 8
# csrc/deform_windowed.cu's layout: a thread's pixels along a row (a warp
# apart), a block's tile (rows, columns) and its threads
WINDOWED_PX, WINDOWED_TILE, WINDOWED_THREADS = 2, (8, 64), 256


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


def deform_windowed_two_taps(feat: torch.Tensor, off: torch.Tensor, aff: torch.Tensor,
                             kernel: int = 3, radius: int = 4) -> torch.Tensor:
    """K10a's arithmetic as ``csrc/deform_windowed.cu`` does it, for the CPU
    tests: per neighbour only the tent's rows u0 = floor(oy) and u0 + 1 and
    columns v0 = floor(ox) and v0 + 1 (each floor clamped to +-(R + 3)),
    each where it lies in the window [-R, R + 1]; the columns added in
    increasing v to a row sum that starts at +0, the rows in increasing u
    to a neighbour sum that starts at +0, each weight 1 - |o - c| (the
    kernel's ``tent_near``: ``tent`` without its max, which changes nothing
    at these two cells), the plane zero outside the image. Equal bits to
    ``propagate_deformable_windowed_planar`` for any finite plane and
    finite offsets."""
    _check_deformable(off, aff, kernel)
    b, h, w = feat.shape
    flat = feat.reshape(b, h * w)
    rows = torch.arange(h, device=feat.device).view(1, h, 1)
    cols = torch.arange(w, device=feat.device).view(1, 1, w)
    zero = torch.zeros_like(feat)
    lim = radius + 3

    def in_window(c):
        return (c >= -radius) & (c <= radius + 1)

    def tent_near(o, c):
        return 1.0 - torch.abs(o - c.float())

    acc = torch.zeros_like(feat)
    for k, (dy, dx) in enumerate(neighbor_shifts(kernel)):
        oy, ox = off[:, 2 * k], off[:, 2 * k + 1]
        u0, v0 = (torch.clamp(torch.floor(o), -lim, lim).long() for o in (oy, ox))
        neighk = torch.zeros_like(feat)
        for u in (u0, u0 + 1):
            yy = rows + dy + u
            row = torch.zeros_like(feat)
            for v in (v0, v0 + 1):
                xx = cols + dx + v
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).view(b, -1)
                tap = torch.where(ok, torch.gather(flat, 1, idx).view(b, h, w), zero)
                row = torch.where(in_window(v), row + tap * tent_near(ox, v), row)
            neighk = torch.where(in_window(u), neighk + row * tent_near(oy, u), neighk)
        acc = acc + neighk * aff[:, k]
    return acc


def windowed_map(h: int, w: int):
    """K10a's pixel-to-thread map on one image: {(block row, block column,
    thread): [(y, x), ...]}, the pixels each thread computes (none for a
    thread past the image), as ``csrc/deform_windowed.cu`` lays them out:
    thread t of a block takes row t // 32 of its tile and the columns
    t % 32 + 32 i."""
    th, tw = WINDOWED_TILE
    per_row = tw // WINDOWED_PX
    out = {}
    for by in range(-(-h // th)):
        for bx in range(-(-w // tw)):
            for t in range(WINDOWED_THREADS):
                y = by * th + t // per_row
                xs = [bx * tw + t % per_row + per_row * i for i in range(WINDOWED_PX)]
                out[(by, bx, t)] = [(y, x) for x in xs if y < h and x < w]
    return out


def deform_windowed_case(gen: torch.Generator, device, b: int, h: int, w: int,
                         kernel: int = 3):
    """Inputs on which K10a is timed on the card, from ``gen``: the
    experiment's kind for a ``kernel`` x ``kernel`` stencil
    (``exp_deform3.experiment_case``, drawn with numpy). Returns ((feat,
    off, aff, kernel, RADIUS), library): the library call is the exact
    gather through ``F.grid_sample`` and the weighted sum."""
    (feat, off, aff), library = experiment_case(gen, device, b, h, w, kernel)
    return (feat, off, aff, kernel, RADIUS), library


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
