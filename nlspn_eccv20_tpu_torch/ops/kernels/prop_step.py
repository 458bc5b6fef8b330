"""Kernel K1: one propagation step with its conf weighting, blend and clip,
and its backward K1b.

K1 replaces the TPU kernel ``local_prop._step_kernel``
(``nlspn_eccv20_tpu/ops/pallas/local_prop.py``) and the elementwise work
around it. CUDA source: ``csrc/prop_step.cu``, whose header says what bounds
it on the card (memory: (K2 + 4) planes per step) and how it is laid out.
K1b replaces the JAX package's custom VJP of that step (``_stencil_bwd``, a
pure-JAX VJP there); CUDA source ``csrc/prop_step_bwd.cu``.

``prop_step`` is differentiable: under autograd it runs ``PropStepFunction``,
whose backward is K1b on a CUDA tensor and ``prop_step_bwd_plain`` (the VJP
of ``prop_step_plain``) on a CPU tensor. The clip passes half the gradient
at an exact tie (``out == 0``), as ``jnp.maximum`` does.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.propagate import propagate_local_planar

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"prop_step_f32": [_P] * 5 + [_I] * 6 + [_P]}
_BWD_SIGNATURES = {"prop_step_bwd_f32": [_P] * 9 + [_I] * 6 + [_P]}
BWD_TILE = (8, 32)            # K1b's tile, rows x cols: a thread a pixel


def bwd_blocks(h: int, w: int, kernel: int) -> Iterator[Tuple[int, int, bool]]:
    """(y0, x0, interior) of each block of K1b on an h x w plane, as
    ``csrc/prop_step_bwd.cu`` tiles and classifies them. A block stages its
    tile grown by ``kernel // 2`` on each side; it is interior when that
    region lies inside the plane (no clamp, no edge pixel, every source of
    the gather inside); the rest are border blocks."""
    r = kernel // 2
    rows, cols = BWD_TILE
    for y0 in range(0, h, rows):
        for x0 in range(0, w, cols):
            yield y0, x0, (y0 - r >= 0 and y0 + rows + r <= h
                           and x0 - r >= 0 and x0 + cols + r <= w)


def blend_and_clip(out: torch.Tensor, dep: Optional[torch.Tensor], *,
                   preserve: bool, clip: bool) -> torch.Tensor:
    """The blend and clip of the JAX package's ``_prop_and_blend``
    (models/nlspn.py) after a propagation step."""
    if preserve:
        m = (dep > 0.0).to(out.dtype)
        out = (1.0 - m) * out + m * dep
    if clip:
        out = torch.maximum(out, torch.zeros_like(out))
    return out


def prop_step_plain(pred: torch.Tensor, aff: torch.Tensor,
                    conf: Optional[torch.Tensor], dep: Optional[torch.Tensor],
                    *, kernel: int, preserve: bool, clip: bool) -> torch.Tensor:
    """``propagate_local_planar`` plus the blend and clip."""
    feat = pred * conf if conf is not None else pred
    return blend_and_clip(propagate_local_planar(feat, aff, kernel=kernel), dep,
                          preserve=preserve, clip=clip)


def prop_step_bwd_plain(g: torch.Tensor, pred: torch.Tensor, aff: torch.Tensor,
                        conf: Optional[torch.Tensor], dep: Optional[torch.Tensor],
                        *, kernel: int, preserve: bool, clip: bool,
                        out: Optional[torch.Tensor] = None):
    """(d_pred, d_aff, d_conf) of ``prop_step_plain`` at cotangent ``g``;
    d_conf is None without conf. ``dep`` is data and gets no gradient.
    ``out``, the forward's output, is not read: the VJP recomputes it."""
    def fwd(p, a, *c):
        return prop_step_plain(p, a, c[0] if c else None, dep, kernel=kernel,
                               preserve=preserve, clip=clip)

    primals = (pred, aff) if conf is None else (pred, aff, conf)
    _, vjp = torch.func.vjp(fwd, *primals)
    grads = vjp(g)
    return grads[0], grads[1], grads[2] if conf is not None else None


def _check_inputs(pred, aff, conf, dep, kernel, preserve):
    b, h, w = pred.shape
    build.check_tensor(pred, "prop_step pred")
    build.check_tensor(aff, "prop_step aff", (b, kernel * kernel, h, w), pred.device)
    for name, t in (("conf", conf), ("dep", dep if preserve else None)):
        if t is not None:
            build.check_tensor(t, f"prop_step {name}", (b, h, w), pred.device)


def _launch_fwd(pred, aff, conf, dep, kernel, preserve, clip):
    b, h, w = pred.shape
    _check_inputs(pred, aff, conf, dep, kernel, preserve)
    out = torch.empty_like(pred)
    with torch.cuda.device(pred.device):
        lib = build.load("prop_step", _SIGNATURES)
        err = lib.prop_step_f32(
            pred.data_ptr(), aff.data_ptr(),
            conf.data_ptr() if conf is not None else None,
            dep.data_ptr() if preserve else None, out.data_ptr(),
            b, h, w, kernel // 2, int(preserve), int(clip),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "prop_step")
    prop_step.launches += 1
    return out


def prop_step_bwd(g: torch.Tensor, pred: torch.Tensor, aff: torch.Tensor,
                  conf: Optional[torch.Tensor] = None,
                  dep: Optional[torch.Tensor] = None, *, kernel: int = 3,
                  preserve: bool = False, clip: bool = False,
                  out: Optional[torch.Tensor] = None):
    """K1b: (d_pred, d_aff, d_conf) at cotangent ``g`` (B, H, W). ``out``,
    the forward's output, lets the clip's factor skip recomputing the step
    where out > 0. On a CPU tensor it runs ``prop_step_bwd_plain``; on a
    CUDA tensor it launches the kernel or raises."""
    if pred.device.type == "cpu":
        return prop_step_bwd_plain(g, pred, aff, conf, dep, kernel=kernel,
                                   preserve=preserve, clip=clip)
    b, h, w = pred.shape
    _check_inputs(pred, aff, conf, dep, kernel, preserve)
    build.check_tensor(g, "prop_step_bwd g", (b, h, w), pred.device)
    if out is not None:
        build.check_tensor(out, "prop_step_bwd out", (b, h, w), pred.device)
    d_pred = torch.empty_like(pred)
    d_aff = torch.empty_like(aff)
    d_conf = torch.empty_like(pred) if conf is not None else None
    with torch.cuda.device(pred.device):
        lib = build.load("prop_step_bwd", _BWD_SIGNATURES)
        err = lib.prop_step_bwd_f32(
            g.data_ptr(), pred.data_ptr(), aff.data_ptr(),
            conf.data_ptr() if conf is not None else None,
            dep.data_ptr() if preserve else None,
            out.data_ptr() if clip and out is not None else None,
            d_pred.data_ptr(), d_aff.data_ptr(),
            d_conf.data_ptr() if conf is not None else None,
            b, h, w, kernel // 2, int(preserve), int(clip),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "prop_step_bwd")
    prop_step_bwd.launches += 1
    return d_pred, d_aff, d_conf


class PropStepFunction(torch.autograd.Function):
    """K1 forward, K1b backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, pred, aff, conf, dep, kernel, preserve, clip):
        ctx.opts = dict(kernel=kernel, preserve=preserve, clip=clip)
        if pred.device.type == "cpu":
            out = prop_step_plain(pred, aff, conf, dep, **ctx.opts)
        else:
            out = _launch_fwd(pred, aff, conf, dep, kernel, preserve, clip)
        # with the clip the output is saved too (the next step's saved pred:
        # no memory of its own): K1b recomputes the step only where out == 0
        ctx.save_for_backward(pred, aff, conf, dep, out if clip else None)
        return out

    @staticmethod
    def backward(ctx, g):
        pred, aff, conf, dep, out = ctx.saved_tensors
        d_pred, d_aff, d_conf = prop_step_bwd(g.contiguous(), pred, aff, conf,
                                              dep, out=out, **ctx.opts)
        return d_pred, d_aff, d_conf, None, None, None, None


def prop_step(pred: torch.Tensor, aff: torch.Tensor,
              conf: Optional[torch.Tensor] = None,
              dep: Optional[torch.Tensor] = None, *, kernel: int = 3,
              preserve: bool = False, clip: bool = False) -> torch.Tensor:
    """pred/conf/dep: (B, H, W) f32; aff: (B, kernel**2, H, W) f32 with the
    center at kernel**2 // 2. ``preserve`` pins pixels where dep > 0 to dep;
    ``clip`` clamps at 0. Returns (B, H, W)."""
    if preserve and dep is None:
        raise ValueError("preserve=True needs dep")
    if kernel % 2 != 1:
        raise ValueError(f"kernel must be odd, got {kernel}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (pred, aff, conf)):
        return PropStepFunction.apply(pred, aff, conf, dep, kernel, preserve, clip)
    if pred.device.type == "cpu":
        return prop_step_plain(pred, aff, conf, dep, kernel=kernel,
                               preserve=preserve, clip=clip)
    return _launch_fwd(pred, aff, conf, dep, kernel, preserve, clip)


prop_step.launches = 0
prop_step_bwd.launches = 0


def _unfolded(feat: torch.Tensor, kernel: int) -> torch.Tensor:
    """(B, K2, H, W): the K2 replicate-padded neighbours of each pixel."""
    b, h, w = feat.shape
    r = kernel // 2
    padded = F.pad(feat[:, None], (r, r, r, r), mode="replicate")
    return F.unfold(padded, kernel).view(b, kernel * kernel, h, w)


def step_inputs(gen: torch.Generator, b: int, h: int, w: int, kernel: int,
                ties: bool):
    """(pred, aff, conf, dep) of one step on the CPU, from ``gen``: pred in
    [0, 10), TGASS-normalised affinities, conf in [0, 1), sparse depth at
    NYU's density (500 samples of 228x304); with ``ties`` pred and dep zero
    over a 64x64 corner."""
    from nlspn_eccv20_tpu_torch.ops.affinity import normalize_affinity

    k2 = kernel * kernel
    pred = 10.0 * torch.rand((b, h, w), generator=gen)
    aff = normalize_affinity(torch.randn((b, k2 - 1, h, w), generator=gen),
                             torch.full((1,), 0.5 * (k2 - 1))).contiguous()
    conf = torch.rand((b, h, w), generator=gen)
    keep = torch.rand((b, h, w), generator=gen) < 500 / (228 * 304)
    dep = keep * (0.5 + 9.5 * torch.rand((b, h, w), generator=gen))
    if ties:   # the clip's exact ties: an all-zero corner
        pred[:, :64, :64] = 0.0
        dep[:, :64, :64] = 0.0
    return pred, aff, conf, dep


def prop_step_case(gen: torch.Generator, device, b: int, h: int, w: int,
                   kernel: int = 3):
    """Inputs on which K1 is timed on the card, from ``gen``: pred in
    [0, 10), TGASS-normalised affinities, conf in [0, 1) and sparse depth at
    NYU's density (500 samples of 228x304), with the model's options (conf,
    preserve, no clip). Returns (args of ``prop_step``, its options,
    library): the library call is the same step as one PyTorch call
    sequence (replicate pad, ``F.unfold``, the weighted sum, the blend),
    which the port never calls."""
    args = tuple(t.to(device) for t in step_inputs(gen, b, h, w, kernel, False))
    pred, aff, conf, dep = args
    kw = dict(kernel=kernel, preserve=True, clip=False)

    def library():
        acc = (_unfolded(pred * conf, kernel) * aff).sum(1)
        return blend_and_clip(acc, dep, preserve=True, clip=False)

    return args, kw, library


def prop_step_bwd_case(gen: torch.Generator, device, b: int, h: int, w: int,
                       kernel: int = 3, clip: bool = False):
    """Inputs on which K1b is checked and timed on the card, from ``gen``:
    ``prop_step_case``'s step and g ~ N(0, 1); with ``clip`` the clip on,
    pred and dep zero over a 64x64 corner (the clip's exact ties), and the
    forward's output passed as ``out`` (as ``PropStepFunction`` saves it).
    Returns (args of ``prop_step_bwd``, its options, library): the library
    call is autograd's backward of ``prop_step_case``'s PyTorch form,
    written out from what that forward saves (the unfolded neighbours):
    ``F.fold`` of aff * ga, the replicate pad's backward, the products."""
    pred, aff, conf, dep = step_inputs(gen, b, h, w, kernel, clip)
    g = torch.randn((b, h, w), generator=gen)
    g, pred, aff, conf, dep = (t.to(device) for t in (g, pred, aff, conf, dep))
    kw = dict(kernel=kernel, preserve=True, clip=clip)
    if clip:
        kw["out"] = prop_step(pred, aff, conf, dep, **kw)
    r = kernel // 2
    feat = pred * conf
    unf = _unfolded(feat, kernel)
    m = (dep > 0).to(g.dtype)
    v = (1.0 - m) * (unf * aff).sum(1) + m * dep

    def library():
        ga = g * (1.0 - m)
        if clip:
            ga = ga * torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0))
        cols = (aff * ga[:, None]).view(b, kernel * kernel, h * w)
        d_pad = F.fold(cols, (h + 2 * r, w + 2 * r), kernel)
        d_feat = torch.ops.aten.replication_pad2d_backward(
            d_pad, feat[:, None], [r, r, r, r])[:, 0]
        return d_feat * conf, unf * ga[:, None], d_feat * pred

    return (g, pred, aff, conf, dep), kw, library
