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
from typing import Optional

import torch

from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.propagate import propagate_local_planar

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"prop_step_f32": [_P] * 5 + [_I] * 6 + [_P]}
_BWD_SIGNATURES = {"prop_step_bwd_f32": [_P] * 8 + [_I] * 6 + [_P]}


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
                        *, kernel: int, preserve: bool, clip: bool):
    """(d_pred, d_aff, d_conf) of ``prop_step_plain`` at cotangent ``g``;
    d_conf is None without conf. ``dep`` is data and gets no gradient."""
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
                  preserve: bool = False, clip: bool = False):
    """K1b: (d_pred, d_aff, d_conf) at cotangent ``g`` (B, H, W). On a CPU
    tensor it runs ``prop_step_bwd_plain``; on a CUDA tensor it launches
    the kernel or raises."""
    if pred.device.type == "cpu":
        return prop_step_bwd_plain(g, pred, aff, conf, dep, kernel=kernel,
                                   preserve=preserve, clip=clip)
    b, h, w = pred.shape
    _check_inputs(pred, aff, conf, dep, kernel, preserve)
    build.check_tensor(g, "prop_step_bwd g", (b, h, w), pred.device)
    d_pred = torch.empty_like(pred)
    d_aff = torch.empty_like(aff)
    d_conf = torch.empty_like(pred) if conf is not None else None
    with torch.cuda.device(pred.device):
        lib = build.load("prop_step_bwd", _BWD_SIGNATURES)
        err = lib.prop_step_bwd_f32(
            g.data_ptr(), pred.data_ptr(), aff.data_ptr(),
            conf.data_ptr() if conf is not None else None,
            dep.data_ptr() if preserve else None,
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
        ctx.save_for_backward(pred, aff, conf, dep)
        if pred.device.type == "cpu":
            return prop_step_plain(pred, aff, conf, dep, **ctx.opts)
        return _launch_fwd(pred, aff, conf, dep, kernel, preserve, clip)

    @staticmethod
    def backward(ctx, g):
        pred, aff, conf, dep = ctx.saved_tensors
        d_pred, d_aff, d_conf = prop_step_bwd(g.contiguous(), pred, aff, conf,
                                              dep, **ctx.opts)
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
