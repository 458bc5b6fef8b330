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
from typing import List, Optional, Tuple

import numpy as np
import torch

from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
    blend_and_clip, case_rng, prop_step, prop_step_bwd, prop_step_plain, step_inputs,
    tgass_affinity)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"prop_loop_f32": [_P] * 6 + [_I] * 9 + [_P]}
_BWD_SIGNATURES = {"prop_loop_bwd_f32": [_P] * 9 + [_I] * 10 + [_P]}

TILE = 32                 # output tile side of a block
SMEM_BYTES = 232448       # shared memory a block may opt in to on Hopper
# the most threads a K6 block takes, by radius: its 65536 registers over
# them (``csrc/prop_loop.cu`` max_threads); any other radius reads its
# affinities from L2 at each step and takes 1024
LOOP_THREADS = {1: 768, 2: 384}
OTHER_THREADS = 1024
REGISTERS = 65536         # an SM's


def loop_max_threads(kernel: int) -> int:
    return LOOP_THREADS.get(kernel // 2, OTHER_THREADS)


def strip_registers(kernel: int) -> int:
    """The registers a K6 thread's constants take: its strip's 4 cells'
    K2 affinities (at radius 1 and 2), conf and m * dep."""
    k2 = kernel * kernel if kernel // 2 in LOOP_THREADS else 0
    return 4 * (k2 + 2)


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def loop_threads(tile: int, steps: int, kernel: int) -> int:
    """The threads of a K6 block running ``steps`` steps on tiles of side
    ``tile``: a strip of 4 cells each over its first step's region, the
    tile grown by e = (steps - 1) r rows and round4(e) columns a side, in
    whole warps."""
    e = (steps - 1) * (kernel // 2)
    strips = (tile + 2 * e) * ((tile + 2 * _round4(e)) // 4)
    return -(-strips // 32) * 32


def loop_smem_bytes(tile: int, steps: int, kernel: int) -> int:
    """K6's two p buffers: the tile grown by steps r rows and by
    round4((steps - 1) r) + round4(r) columns a side."""
    r = kernel // 2
    bw = tile + 2 * (_round4((steps - 1) * r) + _round4(r))
    return 4 * 2 * (tile + 2 * steps * r) * bw


def loop_strips(tile: int, steps: int, kernel: int):
    """K6's strips of one block, as its threads hold them: a list of
    (thread, y, x, last), the strip's cells (y, x .. x + 3) relative to the
    tile's origin, ``last`` the last step that computes them (the strip's
    nearest cell within (steps - s) r of the tile)."""
    r = kernel // 2
    e = (steps - 1) * r
    ex = _round4(e)
    cols = (tile + 2 * ex) // 4
    strips = []
    for t in range((tile + 2 * e) * cols):
        y, x = -e + t // cols, -ex + 4 * (t % cols)
        d = max(-y, y - tile + 1, -(x + 3), x - tile + 1, 0)
        strips.append((t, y, x, steps - (d + r - 1) // r if d else steps))
    return strips


def plan(steps: int, kernel: int, shape: Tuple[int, int, int], sms: int,
         backward: bool = False, clip: bool = False) -> Tuple[int, List[Tuple[int, int]]]:
    """The tile side and the (first, last + 1) steps of each launch, for
    planes of ``shape`` (B, H, W) on a card with ``sms`` SMs (neither
    changes the plan at present: it follows the kernel and steps). The forward's
    launch holds its first step's region in its threads' registers, a
    strip of 4 cells a thread of at most ``loop_max_threads``, and its two
    p buffers in shared memory; its tiles are 32x32, halved while that
    leaves fewer than min(steps, 2) steps a launch (3x3: 32x32 tiles, 12
    steps a launch, the model's loop one launch at every batch; 5x5: 32x32,
    2). The backward's launch holds the loop's constants, three step inputs
    and two G buffers over the tile grown by steps r, one r more with the
    clip (``_bwd_floats``); its tiles are 32x32, halved while that leaves
    fewer than min(steps, 4) steps a launch (at b=1 of 228x304 its 80
    blocks of 32x32 beat 285 of 16x16: the halo is the larger cost)."""
    def most(t):  # the steps a launch takes with tiles of side t
        n = 0
        while n < steps and (
                4 * _bwd_floats(t, n + 1, kernel, clip) <= SMEM_BYTES if backward else
                loop_threads(t, n + 1, kernel) <= loop_max_threads(kernel)
                and loop_smem_bytes(t, n + 1, kernel) <= SMEM_BYTES):
            n += 1
        return n

    tile = TILE
    while tile > 8 and most(tile) < min(steps, 4 if backward else 2):
        tile //= 2
    per_launch = most(tile)
    if per_launch < 1:
        raise ValueError(f"a {kernel}x{kernel} loop does not fit in a block")
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


def prop_loop_case(gen: torch.Generator, device, b: int, h: int, w: int,
                   kernel: int = 3, steps: int = 12, save: bool = False):
    """Inputs on which K6 is checked and timed on the card, from ``gen``:
    ``prop_step.step_inputs``' pred in [0, 10), TGASS-normalised
    affinities, conf in [0, 1) and sparse depth at NYU's density, with the
    model's options (conf, preserve, no clip, no pre-blend). Returns (args,
    kw, library): ``launch_fwd(*args, **kw)`` is the kernel's call (with
    ``save`` the training form, which also writes the step inputs) and
    ``prop_loop_plain(*args, **kw)`` without ``save`` its plain version;
    the library call is ``steps`` launches of K1 on the same inputs, the
    per-step route (no single PyTorch call computes the loop)."""
    pred, aff, conf, dep = (t.to(device) for t in step_inputs(gen, b, h, w, kernel, False))
    kw = dict(steps=steps, kernel=kernel, preserve=True, clip=False, pre_blend=False,
              save=save)

    def library():
        p = pred
        for _ in range(steps):
            p = prop_step(p, aff, conf, dep, kernel=kernel, preserve=True, clip=False)
        return p

    return (pred, aff, conf, dep), kw, library


def prop_loop_bwd_case(gen: torch.Generator, device, b: int, h: int, w: int,
                       kernel: int = 3, steps: int = 12, ties: bool = False):
    """Inputs on which K6b is checked and timed on the card, from ``gen``
    (through ``prop_step.case_rng``): pred in [0, 10), TGASS-normalised affinities, conf in [0, 1), sparse
    depth at NYU's density (500 samples of 228x304) and g ~ N(0, 1), with
    the model's options (conf, preserve, no clip, no pre-blend); with
    ``ties`` the clip and the pre-blend on, pred and dep zero over a 64x64
    corner (the clip's exact ties). ``saved`` is what K6 writes on a CUDA
    tensor, None on a CPU one (``prop_loop_bwd`` does not read it there).
    Returns (args of ``prop_loop_bwd``, its options, library): the library
    call is ``steps`` launches of K1b on the same inputs, the per-step
    route (no single PyTorch call computes the loop's backward)."""
    rng = case_rng(gen)

    def rand():
        return torch.from_numpy(rng.random((b, h, w), dtype=np.float32))

    aff = tgass_affinity(rng, b, kernel, h, w)
    pred = 10.0 * rand()
    conf = rand()
    keep = rand() < 500 / (228 * 304)
    dep = keep * (0.5 + 9.5 * rand())
    g = torch.from_numpy(rng.standard_normal((b, h, w), dtype=np.float32))
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
