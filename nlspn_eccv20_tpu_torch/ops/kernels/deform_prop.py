"""Kernel K7: one deformable (``--offset``) propagation step with its conf
weighting, blend and clip, and its backward K8.

K7 replaces the TPU kernel ``deform_prop._fwd_kernel`` (reached from
``_deform_fwd_pallas``, ``nlspn_eccv20_tpu/ops/pallas/deform_prop.py``) and
the elementwise work around it (models/nlspn.py ``_prop_and_blend``); CUDA
source ``csrc/deform_prop.cu``. K8 replaces its backward
(``_deform_bwd_pallas``: ``_bwd_kernel`` and ``_bwd_scatter_kernel``); CUDA
source ``csrc/deform_prop_bwd.cu``. Each source's header says what bounds it
on the card and how it is laid out.

The forward is the exact bilinear gather, zero outside the image, for any
offsets: that is what the JAX package computes in eval (its windowed form
inside the window, its exact gather beyond) and in training, where the
caller has clamped the offsets to [-radius, radius] first
(``ops.propagate.clamp_offsets``). The backward follows the windowed form's
gradient conventions (the tent's slope is -sign(t) with sign(0) = +1, half
at |t| = 1, zero outside the window u in [-radius, radius + 1]): it is the
VJP of the windowed form for any offset, which is K7's function only for
offsets in [-radius, radius] (beyond, the window truncates it; K10a in
``devtools`` computes that truncated form and takes K8 as its backward
there too). With ``radius`` None (training
at ``offset_window=0``) the offsets are not clamped and the backward is
``deform_prop_exact_bwd_plain``, the VJP of the exact gather: the JAX
package differentiates its exact gather with XLA's autodiff there and has no
Pallas kernel for it, so a plain PyTorch backward, on the card too, is its
faithful counterpart, not a fall back. (On the card, autograd's backward of
``torch.gather`` scatters with atomic adds, so its d_pred and d_conf can
differ in the last bits from run to run.)

``deform_prop`` is differentiable: under autograd it runs
``DeformPropFunction``, whose backward is K8 on a CUDA tensor and
``deform_prop_bwd_plain`` on a CPU tensor (with a radius; without one,
``deform_prop_exact_bwd_plain`` on either). ``deform_prop_plain`` is the same
op through the plain versions on any device (forward and backward), which
``chip_smoke.py`` holds the kernels against.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
    blend_and_clip, case_rng, step_inputs, tgass_affinity)
from nlspn_eccv20_tpu_torch.ops.propagate import (
    neighbor_shifts,
    propagate_deformable_exact_planar,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"deform_prop_f32": [_P] * 6 + [_I] * 8 + [_P]}
_BWD_SIGNATURES = {"deform_prop_bwd_f32": [_P] * 11 + [_I] * 7 + [_P]}
FWD_TILE_COLS = 32            # K7's tile width: a warp of threads
FWD_THREAD_ROWS = 8           # its thread rows
FWD_PIXELS = (4, 2, 1)        # pixels a thread, down its column
# R_s for offsets that are not clamped (served): the default training
# clamp's 4, which a trained model's offsets should mostly keep to; taps past
# it are read from device memory
STAGE_RADIUS = 4
STAGE_RADIUS_CAP = 8          # the largest R_s staged


def fwd_plan(b: int, h: int, w: int, kernel: int, radius: Optional[int],
             sms: int) -> Tuple[int, int, int]:
    """K7's tile (rows, cols) and staging margin M on a card with ``sms``
    SMs. A tile is 32 columns and 8 n rows, n the most of 4, 2, 1 pixels a
    thread that still gives every SM two blocks. p is staged over the tile
    grown by M = kernel // 2 + R_s + 1, which holds every tap of an offset
    in [-R_s, R_s]: R_s is ``radius`` (the training clamp's), or
    ``STAGE_RADIUS`` for offsets that are not clamped, at most 8."""
    cols = -(-w // FWD_TILE_COLS)
    for n in FWD_PIXELS:
        if b * -(-h // (FWD_THREAD_ROWS * n)) * cols >= 2 * sms:
            break
    r_s = min(STAGE_RADIUS if radius is None else radius, STAGE_RADIUS_CAP)
    return FWD_THREAD_ROWS * n, FWD_TILE_COLS, kernel // 2 + r_s + 1


def fwd_blocks(h: int, w: int, rows: int, cols: int,
               margin: int) -> Iterator[Tuple[int, int, bool]]:
    """(y0, x0, interior) of each block of K7 on an h x w plane, as
    ``csrc/deform_prop.cu`` classifies them: interior when the tile grown by
    ``margin`` lies inside the plane (its staging needs no bounds check)."""
    for y0 in range(0, h, rows):
        for x0 in range(0, w, cols):
            yield y0, x0, (y0 - margin >= 0 and y0 + rows + margin <= h
                           and x0 - margin >= 0 and x0 + cols + margin <= w)


def deform_prop_fwd_plain(pred: torch.Tensor, off: torch.Tensor,
                          aff: torch.Tensor, conf: Optional[torch.Tensor],
                          dep: Optional[torch.Tensor], *, kernel: int,
                          preserve: bool, clip: bool) -> torch.Tensor:
    """``propagate_deformable_exact_planar`` of pred * conf, then the blend
    and clip: K7's function, in the kernel's order of operations."""
    feat = pred * conf if conf is not None else pred
    return blend_and_clip(propagate_deformable_exact_planar(feat, off, aff, kernel),
                          dep, preserve=preserve, clip=clip)


def deform_prop_exact_bwd_plain(g: torch.Tensor, pred: torch.Tensor,
                                off: torch.Tensor, aff: torch.Tensor,
                                conf: Optional[torch.Tensor],
                                dep: Optional[torch.Tensor], *, kernel: int,
                                preserve: bool, clip: bool):
    """(d_pred, d_off, d_aff, d_conf) of ``deform_prop_fwd_plain`` at
    cotangent ``g``, for any offsets: ``torch.func.vjp`` of the exact gather,
    whose fractions give the floor-based bilinear gradients (the slope of
    each tap's weight in the offset, with no term from the floor); d_conf is
    None without conf, ``dep`` is data."""
    def fwd(p, o, a, *c):
        return deform_prop_fwd_plain(p, o, a, c[0] if c else None, dep,
                                     kernel=kernel, preserve=preserve, clip=clip)

    primals = (pred, off, aff) if conf is None else (pred, off, aff, conf)
    _, vjp = torch.func.vjp(fwd, *primals)
    grads = vjp(g)
    return grads + (None,) if conf is None else grads


def _tent_and_slope(t: torch.Tensor):
    """max(0, 1 - |t|) and its derivative with JAX's ties (``_dhat`` of the
    TPU backward): -sign(t) with sign(0) = +1, times 1 inside the support,
    1/2 at |t| == 1 and 0 beyond."""
    az = torch.where(t >= 0, t, -t)
    one = torch.ones_like(t)
    mag = torch.where(az < 1, one, torch.where(az == 1, 0.5 * one, 0 * one))
    return torch.clamp_min(1.0 - az, 0.0), torch.where(t >= 0, -mag, mag)


def deform_prop_bwd_plain(g: torch.Tensor, pred: torch.Tensor, off: torch.Tensor,
                          aff: torch.Tensor, conf: Optional[torch.Tensor],
                          dep: Optional[torch.Tensor], *, kernel: int, radius: int,
                          preserve: bool, clip: bool):
    """(d_pred, d_off, d_aff, d_conf) of K7's function at cotangent ``g``,
    for offsets in [-radius, radius] (beyond, of the window form, which the
    window truncates); d_conf is None without conf, ``dep``
    is data. Written out as the TPU backward computes it: for each
    neighbour k and each (u, v) of the window [-radius, radius + 1]^2 around
    its kernel shift, the tent weights and slopes of the offset read the
    zero-padded plane for d_aff and d_off, and scatter aff * g into a
    padded d_feat; nothing is differentiated by autograd."""
    feat = pred * conf if conf is not None else pred
    ga = g
    if clip:  # jnp.maximum's tie: half the gradient where the output is 0
        v = deform_prop_fwd_plain(pred, off, aff, conf, dep, kernel=kernel,
                                  preserve=preserve, clip=False)
        one = torch.ones_like(v)
        ga = ga * torch.where(v > 0, one, torch.where(v == 0, 0.5 * one, 0 * one))
    if preserve:
        ga = ga * (1.0 - (dep > 0.0).to(g.dtype))
    _, h, w = feat.shape
    rp = radius + 1 + kernel // 2
    p = F.pad(feat, (rp, rp, rp, rp))
    dp = torch.zeros_like(p)
    d_off, d_aff = torch.empty_like(off), torch.empty_like(aff)
    window = range(-radius, radius + 2)
    for k, (dy, dx) in enumerate(neighbor_shifts(kernel)):
        oy, ox = off[:, 2 * k], off[:, 2 * k + 1]
        q = aff[:, k] * ga
        wxs = [_tent_and_slope(ox - v) for v in window]
        s, doy, dox = (torch.zeros_like(feat) for _ in range(3))
        for u in window:
            wy, dwy = _tent_and_slope(oy - u)
            qy = q * wy
            row, row_dx = torch.zeros_like(feat), torch.zeros_like(feat)
            y0 = rp + dy + u
            for v, (wx, dwx) in zip(window, wxs):
                x0 = rp + dx + v
                patch = p[:, y0:y0 + h, x0:x0 + w]
                row = row + patch * wx
                row_dx = row_dx + patch * dwx
                dp[:, y0:y0 + h, x0:x0 + w] += qy * wx
            s = s + row * wy
            doy = doy + row * dwy
            dox = dox + row_dx * wy
        d_aff[:, k] = s * ga
        d_off[:, 2 * k] = doy * q
        d_off[:, 2 * k + 1] = dox * q
    d_feat = dp[:, rp:rp + h, rp:rp + w]
    if conf is None:
        return d_feat, d_off, d_aff, None
    return d_feat * conf, d_off, d_aff, d_feat * pred


def _check_inputs(pred, off, aff, conf, dep, kernel, preserve):
    b, h, w = pred.shape
    k2 = kernel * kernel
    build.check_tensor(pred, "deform_prop pred")
    build.check_tensor(off, "deform_prop off", (b, 2 * k2, h, w), pred.device)
    build.check_tensor(aff, "deform_prop aff", (b, k2, h, w), pred.device)
    for name, t in (("conf", conf), ("dep", dep if preserve else None)):
        if t is not None:
            build.check_tensor(t, f"deform_prop {name}", (b, h, w), pred.device)


def _launch_fwd(pred, off, aff, conf, dep, kernel, radius, preserve, clip):
    b, h, w = pred.shape
    _check_inputs(pred, off, aff, conf, dep, kernel, preserve)
    out = torch.empty_like(pred)
    rows, _, margin = fwd_plan(b, h, w, kernel, radius, torch.cuda.get_device_properties(
        pred.device).multi_processor_count)
    with torch.cuda.device(pred.device):
        lib = build.load("deform_prop", _SIGNATURES)
        err = lib.deform_prop_f32(
            pred.data_ptr(), off.data_ptr(), aff.data_ptr(),
            conf.data_ptr() if conf is not None else None,
            dep.data_ptr() if preserve else None, out.data_ptr(),
            b, h, w, kernel // 2, int(preserve), int(clip),
            rows // FWD_THREAD_ROWS, margin,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "deform_prop")
    deform_prop.launches += 1
    return out


def deform_prop_bwd(g: torch.Tensor, pred: torch.Tensor, off: torch.Tensor,
                    aff: torch.Tensor, conf: Optional[torch.Tensor] = None,
                    dep: Optional[torch.Tensor] = None, *, kernel: int = 3,
                    radius: int = 4, preserve: bool = False, clip: bool = False):
    """K8: (d_pred, d_off, d_aff, d_conf) at cotangent ``g`` (B, H, W), as
    ``deform_prop_bwd_plain``: K7's gradient for offsets in [-radius,
    radius] (the training clamp's range), the window form's beyond. On a
    CPU tensor it runs ``deform_prop_bwd_plain``; on a CUDA tensor it
    launches the kernel or raises."""
    if pred.device.type == "cpu":
        return deform_prop_bwd_plain(g, pred, off, aff, conf, dep, kernel=kernel,
                                     radius=radius, preserve=preserve, clip=clip)
    b, h, w = pred.shape
    _check_inputs(pred, off, aff, conf, dep, kernel, preserve)
    build.check_tensor(g, "deform_prop_bwd g", (b, h, w), pred.device)
    d_pred, ga = torch.empty_like(pred), torch.empty_like(pred)
    d_off, d_aff = torch.empty_like(off), torch.empty_like(aff)
    d_conf = torch.empty_like(pred) if conf is not None else None
    with torch.cuda.device(pred.device):
        lib = build.load("deform_prop_bwd", _BWD_SIGNATURES)
        err = lib.deform_prop_bwd_f32(
            g.data_ptr(), pred.data_ptr(), off.data_ptr(), aff.data_ptr(),
            conf.data_ptr() if conf is not None else None,
            dep.data_ptr() if preserve else None,
            d_pred.data_ptr(), d_off.data_ptr(), d_aff.data_ptr(),
            d_conf.data_ptr() if conf is not None else None, ga.data_ptr(),
            b, h, w, kernel // 2, radius, int(preserve), int(clip),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "deform_prop_bwd")
    deform_prop_bwd.launches += 1
    return d_pred, d_off, d_aff, d_conf


class DeformPropFunction(torch.autograd.Function):
    """K7 forward, K8 backward; their plain versions on CPU tensors or
    with ``plain``."""

    @staticmethod
    def forward(ctx, pred, off, aff, conf, dep, kernel, radius, preserve, clip,
                plain):
        ctx.opts = dict(kernel=kernel, preserve=preserve, clip=clip)
        ctx.radius, ctx.plain = radius, plain
        ctx.save_for_backward(pred, off, aff, conf, dep)
        if plain or pred.device.type == "cpu":
            return deform_prop_fwd_plain(pred, off, aff, conf, dep, **ctx.opts)
        return _launch_fwd(pred, off, aff, conf, dep, kernel, radius, preserve, clip)

    @staticmethod
    def backward(ctx, g):
        pred, off, aff, conf, dep = ctx.saved_tensors
        if ctx.radius is None:   # the exact gather's VJP, as JAX's autodiff
            d_pred, d_off, d_aff, d_conf = deform_prop_exact_bwd_plain(
                g.contiguous(), pred, off, aff, conf, dep, **ctx.opts)
        else:
            bwd = deform_prop_bwd_plain if ctx.plain else deform_prop_bwd
            d_pred, d_off, d_aff, d_conf = bwd(g.contiguous(), pred, off, aff,
                                               conf, dep, radius=ctx.radius,
                                               **ctx.opts)
        return d_pred, d_off, d_aff, d_conf, None, None, None, None, None, None


def _deform(pred, off, aff, conf, dep, kernel, radius, preserve, clip, plain):
    if preserve and dep is None:
        raise ValueError("preserve=True needs dep")
    if kernel % 2 != 1:
        raise ValueError(f"kernel must be odd, got {kernel}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (pred, off, aff, conf)):
        return DeformPropFunction.apply(pred, off, aff, conf, dep, kernel, radius,
                                        preserve, clip, plain)
    if plain or pred.device.type == "cpu":
        return deform_prop_fwd_plain(pred, off, aff, conf, dep, kernel=kernel,
                                     preserve=preserve, clip=clip)
    return _launch_fwd(pred, off, aff, conf, dep, kernel, radius, preserve, clip)


def deform_prop(pred: torch.Tensor, off: torch.Tensor, aff: torch.Tensor,
                conf: Optional[torch.Tensor] = None,
                dep: Optional[torch.Tensor] = None, *, kernel: int = 3,
                radius: Optional[int] = None, preserve: bool = False,
                clip: bool = False) -> torch.Tensor:
    """pred/conf/dep: (B, H, W) f32; off: (B, 2 * kernel**2, H, W) with the
    (dy, dx) pair of neighbour k at channels (2k, 2k + 1); aff:
    (B, kernel**2, H, W), row-major neighbours. ``radius``: the window of
    the backward's tie rules, for offsets already clamped to it (training);
    None for unclamped offsets (eval, and training at ``offset_window=0``),
    whose backward is the exact gather's VJP. ``preserve`` pins pixels
    where dep > 0 to dep; ``clip`` clamps at 0. Returns (B, H, W)."""
    return _deform(pred, off, aff, conf, dep, kernel, radius, preserve, clip,
                   plain=False)


def deform_prop_plain(pred: torch.Tensor, off: torch.Tensor, aff: torch.Tensor,
                      conf: Optional[torch.Tensor] = None,
                      dep: Optional[torch.Tensor] = None, *, kernel: int = 3,
                      radius: Optional[int] = None, preserve: bool = False,
                      clip: bool = False) -> torch.Tensor:
    """``deform_prop`` through the plain versions only, forward and backward,
    on any device."""
    return _deform(pred, off, aff, conf, dep, kernel, radius, preserve, clip,
                   plain=True)


deform_prop.launches = 0
deform_prop_bwd.launches = 0


def sampling_grid(off: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """(B, 2 K2, H, W) offsets -> the (B, K2 H, W, 2) grid of
    ``F.grid_sample`` (align_corners=True) that samples neighbour k at its
    kernel shift ``shifts[k]`` plus its offset. ``shifts``: the (K2, 2)
    ``neighbor_shifts`` as a float tensor on the offsets' device (made
    before a graph capture: no host copy here)."""
    b, _, h, w = off.shape
    k2 = shifts.shape[0]
    sy = (torch.arange(h, device=off.device, dtype=off.dtype).view(1, 1, h, 1)
          + shifts[:, 0].view(1, k2, 1, 1) + off[:, 0::2])
    sx = (torch.arange(w, device=off.device, dtype=off.dtype).view(1, 1, 1, w)
          + shifts[:, 1].view(1, k2, 1, 1) + off[:, 1::2])
    grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0, sy * (2.0 / (h - 1)) - 1.0], -1)
    return grid.view(b, k2 * h, w, 2)


def deform_prop_case(gen: torch.Generator, device, b: int, h: int, w: int,
                     kernel: int = 3, radius: Optional[int] = None,
                     off_std: float = 1.5):
    """Inputs on which K7 is checked and timed on the card, from ``gen``:
    pred in [0, 10), offsets ~ N(0, off_std^2) (clamped to [-radius,
    radius] with a ``radius``, as training clamps them; unclamped without
    one, as served), TGASS affinities, conf in [0, 1) and sparse depth at
    NYU's density, with the model's options (conf, preserve, no clip).
    Returns (args of ``deform_prop``, its options, library): the library
    call is the same step through ``F.grid_sample`` (zeros outside) over the
    stacked sampling grids, the weighted sum and the blend, which the port
    never calls."""
    k2 = kernel * kernel
    pred, aff, conf, dep = step_inputs(gen, b, h, w, kernel, False)
    off = torch.randn((b, 2 * k2, h, w), generator=gen) * off_std
    if radius is not None:
        off = off.clamp(-radius, radius)
    args = tuple(t.to(device).contiguous() for t in (pred, off, aff, conf, dep))
    pred, off, aff, conf, dep = args
    kw = dict(kernel=kernel, radius=radius, preserve=True, clip=False)
    sh = torch.tensor(neighbor_shifts(kernel), device=device, dtype=torch.float32)

    def library():   # the sampling grid from the offsets, then the sampler
        smp = F.grid_sample((pred * conf)[:, None], sampling_grid(off, sh),
                            mode="bilinear", padding_mode="zeros", align_corners=True)
        acc = (smp.view(b, k2, h, w) * aff).sum(1)
        return blend_and_clip(acc, dep, preserve=True, clip=False)

    return args, kw, library


def deform_prop_bwd_case(gen: torch.Generator, device, b: int, h: int, w: int,
                         kernel: int = 3, radius: int = 4, converge: bool = False):
    """Inputs on which K8 is checked and timed on the card, from ``gen``: the
    offset train step's backward (conf, preserve at NYU's 500 samples a
    228x304 frame, no clip) on an h x w plane, offsets ~ N(0, 1.5^2)
    clamped to the window, TGASS affinities. With ``converge`` every output
    points each neighbour at the nearest node of a grid 2R apart (plus a
    quarter pixel, within the clamp): up to (2R)^2 outputs of a neighbour
    share one corner, the largest bins of K8's gather. Returns (args,
    keyword arguments of ``deform_prop_bwd`` and its plain version,
    library): ``library`` is autograd's backward of the same step through
    ``F.grid_sample`` (zeros outside, over the stacked sampling grids),
    written out: the sampler's backward, then the elementwise rest."""
    k2 = kernel * kernel
    rng = case_rng(gen)

    def rand(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32))

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    pred = 10.0 * rand(b, h, w)
    off = randn(b, 2 * k2, h, w) * 1.5
    aff = tgass_affinity(rng, b, kernel, h, w)
    conf = rand(b, h, w)
    keep = rand(b, h, w) < 500 / (228 * 304)
    dep = keep * (0.5 + 9.5 * rand(b, h, w))
    g = randn(b, h, w)
    if converge:
        step = 2 * max(radius, 1)
        ys = torch.arange(h, dtype=torch.float32).view(h, 1)
        xs = torch.arange(w, dtype=torch.float32).view(1, w)
        ny = torch.round(ys / step) * step + 0.25
        nx = torch.round(xs / step) * step + 0.25
        for k, (dy, dx) in enumerate(neighbor_shifts(kernel)):
            off[:, 2 * k] = ny - ys - dy
            off[:, 2 * k + 1] = nx - xs - dx
    off = off.clamp(-radius, radius)
    pred, off, aff, conf, dep, g = (t.to(device).contiguous()
                                    for t in (pred, off, aff, conf, dep, g))
    kw = dict(kernel=kernel, radius=radius, preserve=True, clip=False)

    sh = torch.tensor(neighbor_shifts(kernel), device=device, dtype=torch.float32)
    grid = sampling_grid(off, sh)
    feat4 = (pred * conf)[:, None]
    smp = F.grid_sample(feat4, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True).view(b, k2, h, w)

    def library():
        ga = g * (1.0 - (dep > 0).float())
        d_feat, d_grid = torch.ops.aten.grid_sampler_2d_backward(
            (ga[:, None] * aff).view(b, 1, -1, w), feat4, grid, 0, 0, True,
            [True, True])
        d_grid = d_grid.view(b, k2, h, w, 2)
        d_off = torch.stack([d_grid[..., 1] * (2.0 / (h - 1)),
                             d_grid[..., 0] * (2.0 / (w - 1))], 2)
        d_feat = d_feat[:, 0]
        return (d_feat * conf, d_off.view(b, 2 * k2, h, w), ga[:, None] * smp,
                d_feat * pred)

    return (g, pred, off, aff, conf, dep), kw, library
