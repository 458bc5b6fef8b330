"""Kernel K6: the whole constant-affinity propagation loop (``steps``
propagation steps with their conf weighting, blend and clip) in one launch,
and its backward K6b.

K6 replaces the TPU kernel ``local_prop._loop_kernel`` (launched from
``_propagate_loop_core``, ``nlspn_eccv20_tpu/ops/pallas/local_prop.py``);
CUDA source ``csrc/prop_loop.cu``. K6b replaces the JAX package's VJP of
that loop (``_loop_op_bwd``, a pure-JAX VJP through ``_pure_loop_planar``
there); CUDA source ``csrc/prop_loop_bwd.cu``. Each source's header says
what bounds it on the card and how it is laid out.

``prop_loop`` is differentiable: under autograd it runs
``PropLoopFunction``, whose forward also keeps the step inputs
cur_0 .. cur_{steps-1} (``steps`` planes) and whose backward is K6b on a
CUDA tensor and ``prop_loop_bwd_plain`` (the VJP of ``prop_loop_plain``) on
a CPU tensor. The clip passes half the gradient at an exact tie, as
``jnp.maximum`` does.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from nlspn_eccv20_tpu_torch.ops.affinity import normalize_affinity
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
    blend_and_clip, prop_step_bwd, prop_step_plain)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"prop_loop_f32": [_P] * 6 + [_I] * 9 + [_P]}
_BWD_SIGNATURES = {"prop_loop_bwd_f32": [_P] * 9 + [_I] * 10 + [_P]}

TILE = 32                 # output tile side of a block
SMEM_BYTES = 232448       # shared memory a block may opt in to on Hopper


def plan(steps: int, kernel: int, shape: Tuple[int, int, int], sms: int,
         backward: bool = False, clip: bool = False) -> Tuple[int, List[Tuple[int, int]]]:
    """The tile side and the (first, last + 1) steps of each launch, for
    planes of ``shape`` (B, H, W) on a card with ``sms`` SMs. The forward's
    tiles are 32x32, or 16x16 where a grid of 32x32 ones would leave SMs
    without a block (b=1 at NYU size); a launch takes as many steps as its
    two halo buffers fit in a block's shared memory. The backward's launch
    holds the loop's constants, three step inputs and two G buffers over
    the tile grown by steps r, one r more with the clip (``_bwd_floats``);
    its tiles are 32x32, halved while that leaves fewer than min(steps, 4)
    steps a launch (at b=1 of 228x304 its 80 blocks of 32x32 beat 285 of
    16x16: the halo is the larger cost)."""
    b, h, w = shape
    r = kernel // 2

    def most(t):  # the backward's steps a launch with tiles of side t
        n = 0
        while n < steps and 4 * _bwd_floats(t, n + 1, kernel, clip) <= SMEM_BYTES:
            n += 1
        return n

    if backward:
        tile = TILE
        while tile > 8 and most(tile) < min(steps, 4):
            tile //= 2
        per_launch = most(tile)
    else:
        tile = TILE if b * -(-h // TILE) * -(-w // TILE) >= sms else TILE // 2
        per_launch = steps
        if r:
            side = math.isqrt(SMEM_BYTES // 8)
            per_launch = min(steps, (side - tile) // (2 * r))
    if per_launch < 1:
        raise ValueError(f"a {kernel}x{kernel} loop does not fit in shared memory")
    n = -(-steps // per_launch)
    bounds = [steps * i // n for i in range(n + 1)]
    return tile, list(zip(bounds[:-1], bounds[1:]))


def _bwd_floats(tile: int, steps: int, kernel: int, clip: bool) -> int:
    """Shared-memory floats of a K6b launch of ``steps`` steps, with conf
    and dep: 5 planes (three step inputs, G and the next G), conf, dep and,
    up to 5x5, the affinities, over the tile grown by steps r (one r more
    with the clip); two tile^2 planes of d_p, and the d_aff sums above 5x5
    (up to 5x5 they stay in registers)."""
    r, k2 = kernel // 2, kernel * kernel
    side = tile + 2 * (steps + int(clip)) * r
    return side * side * (7 + (k2 if r <= 2 else 0)) + tile * tile * (2 + (k2 if r > 2 else 0))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_dep(dep, preserve, pre_blend):
    if (preserve or pre_blend) and dep is None:
        raise ValueError("preserve and pre_blend need dep")


def prop_loop_plain(pred: torch.Tensor, aff: torch.Tensor,
                    conf: Optional[torch.Tensor], dep: Optional[torch.Tensor],
                    *, steps: int, kernel: int, preserve: bool, clip: bool,
                    pre_blend: bool) -> torch.Tensor:
    """``steps`` calls of ``prop_step_plain`` with a constant affinity, after
    the optional pre-blend ((1 - m) pred + m dep, then the clip): the JAX
    package's ``_pure_loop_planar``."""
    _check_dep(dep, preserve, pre_blend)
    cur = pred
    if pre_blend:
        cur = blend_and_clip(cur, dep, preserve=True, clip=clip)
    for _ in range(steps):
        cur = prop_step_plain(cur, aff, conf, dep, kernel=kernel,
                              preserve=preserve, clip=clip)
    return cur


def prop_loop_bwd_plain(g: torch.Tensor, pred: torch.Tensor, aff: torch.Tensor,
                        conf: Optional[torch.Tensor], dep: Optional[torch.Tensor],
                        *, steps: int, kernel: int, preserve: bool, clip: bool,
                        pre_blend: bool):
    """(d_pred, d_aff, d_conf) of ``prop_loop_plain`` at cotangent ``g``;
    d_conf is None without conf. ``dep`` is data and gets no gradient."""
    def fwd(p, a, *c):
        return prop_loop_plain(p, a, c[0] if c else None, dep, steps=steps,
                               kernel=kernel, preserve=preserve, clip=clip,
                               pre_blend=pre_blend)

    primals = (pred, aff) if conf is None else (pred, aff, conf)
    _, vjp = torch.func.vjp(fwd, *primals)
    grads = vjp(g)
    return grads[0], grads[1], grads[2] if conf is not None else None


def _check_inputs(pred, aff, conf, dep, kernel, preserve, pre_blend):
    b, h, w = pred.shape
    build.check_tensor(pred, "prop_loop pred")
    build.check_tensor(aff, "prop_loop aff", (b, kernel * kernel, h, w), pred.device)
    for name, t in (("conf", conf), ("dep", dep if preserve or pre_blend else None)):
        if t is not None:
            build.check_tensor(t, f"prop_loop {name}", (b, h, w), pred.device)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def launch_fwd(pred, aff, conf, dep, *, steps, kernel, preserve, clip,
               pre_blend, save=False):
    """K6 on CUDA tensors: the final plane and, with ``save``, the step
    inputs (steps, B, H, W) for K6b (else None). One launch, or one per
    group of steps of ``plan``."""
    b, h, w = pred.shape
    _check_inputs(pred, aff, conf, dep, kernel, preserve, pre_blend)
    tile, chunks = plan(steps, kernel, (b, h, w), _sms(pred.device))
    out = torch.empty_like(pred)
    saved = pred.new_empty((steps, b, h, w)) if save else None
    between = [torch.empty_like(pred) for _ in range(min(len(chunks) - 1, 2))]
    src = pred
    with torch.cuda.device(pred.device):
        lib = build.load("prop_loop", _SIGNATURES)
        stream = torch.cuda.current_stream().cuda_stream
        for i, (k0, k1) in enumerate(chunks):
            dst = out if k1 == steps else between[i % 2]
            err = lib.prop_loop_f32(
                src.data_ptr(), aff.data_ptr(), _ptr(conf),
                _ptr(dep if preserve or pre_blend else None), dst.data_ptr(),
                _ptr(saved[k0] if save else None), b, h, w, kernel // 2,
                k1 - k0, tile, int(preserve), int(clip), int(pre_blend and k0 == 0),
                stream)
            build.check_launch(err, "prop_loop")
            prop_loop.launches += 1
            src = dst
    return out, saved


def prop_loop_bwd(g: torch.Tensor, pred: torch.Tensor, aff: torch.Tensor,
                  conf: Optional[torch.Tensor], dep: Optional[torch.Tensor],
                  saved: Optional[torch.Tensor], *, steps: int, kernel: int = 3,
                  preserve: bool = False, clip: bool = False,
                  pre_blend: bool = False):
    """K6b: (d_pred, d_aff, d_conf) at cotangent ``g`` (B, H, W), from the
    step inputs ``saved`` that ``launch_fwd(save=True)`` wrote. On a CPU
    tensor it runs ``prop_loop_bwd_plain`` (``saved`` is not read); on a
    CUDA tensor it launches the kernel or raises."""
    if pred.device.type == "cpu":
        return prop_loop_bwd_plain(g, pred, aff, conf, dep, steps=steps,
                                   kernel=kernel, preserve=preserve, clip=clip,
                                   pre_blend=pre_blend)
    b, h, w = pred.shape
    _check_inputs(pred, aff, conf, dep, kernel, preserve, pre_blend)
    build.check_tensor(g, "prop_loop_bwd g", (b, h, w), pred.device)
    build.check_tensor(saved, "prop_loop_bwd saved", (steps, b, h, w), pred.device)
    tile, chunks = plan(steps, kernel, (b, h, w), _sms(pred.device), backward=True,
                        clip=clip)
    d_pred = torch.empty_like(pred)
    d_aff = torch.empty_like(aff)
    d_conf = torch.empty_like(pred) if conf is not None else None
    between = [torch.empty_like(pred) for _ in range(min(len(chunks) - 1, 2))]
    src = g
    with torch.cuda.device(pred.device):
        lib = build.load("prop_loop_bwd", _BWD_SIGNATURES)
        stream = torch.cuda.current_stream().cuda_stream
        for i, (k0, k1) in enumerate(reversed(chunks)):
            dst = d_pred if k0 == 0 else between[i % 2]
            err = lib.prop_loop_bwd_f32(
                src.data_ptr(), pred.data_ptr(), aff.data_ptr(), _ptr(conf),
                _ptr(dep if preserve or pre_blend else None), saved[k0].data_ptr(),
                dst.data_ptr(), d_aff.data_ptr(), _ptr(d_conf), b, h, w,
                kernel // 2, k1 - k0, tile, int(preserve), int(clip),
                int(pre_blend and k0 == 0), int(i > 0), stream)
            build.check_launch(err, "prop_loop_bwd")
            prop_loop_bwd.launches += 1
            src = dst
    return d_pred, d_aff, d_conf


class PropLoopFunction(torch.autograd.Function):
    """K6 forward, K6b backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, pred, aff, conf, dep, steps, kernel, preserve, clip, pre_blend):
        ctx.opts = dict(steps=steps, kernel=kernel, preserve=preserve, clip=clip,
                        pre_blend=pre_blend)
        if pred.device.type == "cpu":
            ctx.save_for_backward(pred, aff, conf, dep, None)
            return prop_loop_plain(pred, aff, conf, dep, **ctx.opts)
        out, saved = launch_fwd(pred, aff, conf, dep, save=True, **ctx.opts)
        ctx.save_for_backward(pred, aff, conf, dep, saved)
        return out

    @staticmethod
    def backward(ctx, g):
        pred, aff, conf, dep, saved = ctx.saved_tensors
        d_pred, d_aff, d_conf = prop_loop_bwd(g.contiguous(), pred, aff, conf, dep,
                                              saved, **ctx.opts)
        return d_pred, d_aff, d_conf, None, None, None, None, None, None


def prop_loop(pred: torch.Tensor, aff: torch.Tensor,
              conf: Optional[torch.Tensor] = None,
              dep: Optional[torch.Tensor] = None, *, steps: int,
              kernel: int = 3, preserve: bool = False, clip: bool = False,
              pre_blend: bool = False) -> torch.Tensor:
    """pred/conf/dep: (B, H, W) f32; aff: (B, kernel**2, H, W) with the
    center at kernel**2 // 2, constant over the ``steps`` steps.
    ``pre_blend`` blends (and clips) pred once before the first step;
    ``preserve`` pins pixels where dep > 0 to dep after every step; ``clip``
    clamps at 0 after every step. Returns (B, H, W)."""
    _check_dep(dep, preserve, pre_blend)
    if kernel % 2 != 1:
        raise ValueError(f"kernel must be odd, got {kernel}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (pred, aff, conf)):
        return PropLoopFunction.apply(pred, aff, conf, dep, steps, kernel,
                                      preserve, clip, pre_blend)
    kw = dict(steps=steps, kernel=kernel, preserve=preserve, clip=clip,
              pre_blend=pre_blend)
    if pred.device.type == "cpu":
        return prop_loop_plain(pred, aff, conf, dep, **kw)
    return launch_fwd(pred, aff, conf, dep, **kw)[0]


prop_loop.launches = 0
prop_loop_bwd.launches = 0


def prop_loop_bwd_case(gen: torch.Generator, device, b: int, h: int, w: int,
                       kernel: int = 3, steps: int = 12, ties: bool = False):
    """Inputs on which K6b is checked and timed on the card, from ``gen``:
    pred in [0, 10), TGASS-normalised affinities, conf in [0, 1), sparse
    depth at NYU's density (500 samples of 228x304) and g ~ N(0, 1), with
    the model's options (conf, preserve, no clip, no pre-blend); with
    ``ties`` the clip and the pre-blend on, pred and dep zero over a 64x64
    corner (the clip's exact ties). ``saved`` is what K6 writes on a CUDA
    tensor, None on a CPU one (``prop_loop_bwd`` does not read it there).
    Returns (args of ``prop_loop_bwd``, its options, library): the library
    call is ``steps`` launches of K1b on the same inputs, the per-step
    route (no single PyTorch call computes the loop's backward)."""
    k2 = kernel * kernel
    aff = normalize_affinity(torch.randn((b, k2 - 1, h, w), generator=gen),
                             torch.full((1,), 0.5 * (k2 - 1))).contiguous()
    pred = 10.0 * torch.rand((b, h, w), generator=gen)
    conf = torch.rand((b, h, w), generator=gen)
    keep = torch.rand((b, h, w), generator=gen) < 500 / (228 * 304)
    dep = keep * (0.5 + 9.5 * torch.rand((b, h, w), generator=gen))
    g = torch.randn((b, h, w), generator=gen)
    if ties:
        pred[:, :64, :64] = 0.0
        dep[:, :64, :64] = 0.0
    g, pred, aff, conf, dep = (t.to(device) for t in (g, pred, aff, conf, dep))
    kw = dict(steps=steps, kernel=kernel, preserve=True, clip=ties, pre_blend=ties)
    saved = (launch_fwd(pred, aff, conf, dep, save=True, **kw)[1]
             if pred.is_cuda else None)

    def library():
        d = g
        for s in range(steps - 1, -1, -1):
            d = prop_step_bwd(d, saved[s], aff, conf, dep, kernel=kernel,
                              preserve=True, clip=ties)[0]
        return d

    return (g, pred, aff, conf, dep, saved), kw, library
