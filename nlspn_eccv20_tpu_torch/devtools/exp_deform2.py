"""Kernel K10c, the gather probe, and the plain windowed prototype of the
deformable gather.

Counterpart of the JAX package's ``devtools/exp_deform2.py``:

* K10c (``csrc/gather_probe.cu``) replaces its TPU kernel ``kern`` (reached
  from ``probe_mosaic_gather``): ``take_along_axis`` of a (64, 128) f32
  block along axis 0 or 1, each index taken modulo that axis' length with
  the floor modulo of jnp's ``%`` (never negative). ``probe_gather`` is its
  wrapper; ``probe_gather_plain``, ``torch.gather`` on
  ``torch.remainder(idx, n)``, its plain version;
* ``windowed_deform``: the prototype's tent-window form of the deformable
  gather, written with static slices as XLA would run it, in its absolute
  coordinates (ty = oy + dy, u in [dy - R, dy + R + 1]), its tents with
  jnp's tie rules under autograd (``ops.propagate.tent``); plain PyTorch,
  the experiment's subject, not a kernel.

``main()`` runs the probe along both axes, then, at NYU b=12 of 228x304 and
KITTI b=1 of 240x1216 with offsets clip(N(0, 1.5^2), -4, 4), the prototype's
largest error against ``ops.propagate.propagate_deformable`` and its
device times, forward and forward plus backward of sum(out^2). It needs
the card unless it is given ``device="cpu"`` (then no times).

    python -m nlspn_eccv20_tpu_torch.devtools.exp_deform2
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.device import resolve_device
from nlspn_eccv20_tpu_torch.devtools.exp_deform3 import SHAPES, experiment_inputs
from nlspn_eccv20_tpu_torch.devtools.measure import measure
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.propagate import (
    _check_deformable,
    neighbor_shifts,
    propagate_deformable,
    tent,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gather_probe_f32": [_P] * 3 + [_I] * 3 + [_P]}
RADIUS = 4


def _check_probe(x, idx, axis):
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if x.dim() != 2 or idx.shape != x.shape or x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} and idx {tuple(idx.shape)}: "
                         "want the same non-empty 2-D shape")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")


def probe_gather_plain(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """take_along_axis(x, idx mod x.shape[axis], axis) with the floor
    modulo: x (rows, cols) f32, idx (rows, cols) int32."""
    _check_probe(x, idx, axis)
    return torch.gather(x, axis, torch.remainder(idx, x.shape[axis]).long())


def probe_gather(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """K10c. On a CPU tensor it runs the plain version; on a CUDA tensor
    it launches the kernel or raises."""
    if x.device.type == "cpu":
        return probe_gather_plain(x, idx, axis)
    _check_probe(x, idx, axis)
    build.check_tensor(x, "probe_gather x")
    if not idx.is_contiguous() or idx.device != x.device:
        raise ValueError(f"probe_gather idx: want contiguous on {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        lib = build.load("gather_probe", _SIGNATURES)
        err = lib.gather_probe_f32(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                   x.shape[0], x.shape[1], axis,
                                   torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "gather_probe")
    probe_gather.launches += 1
    return out


probe_gather.launches = 0


def probe_inputs(device):
    """The TPU probe's block and indices: arange(64 * 128) as (64, 128) f32,
    indices uniform in [0, 64) from numpy's generator at seed 0."""
    x = torch.arange(64 * 128, dtype=torch.float32).reshape(64, 128)
    idx = np.random.default_rng(0).integers(0, 64, (64, 128)).astype(np.int32)
    return x.to(device), torch.from_numpy(idx).to(device)


def windowed_deform(feat: torch.Tensor, offset: torch.Tensor, aff: torch.Tensor,
                    kernel: int = 3, radius: int = 4) -> torch.Tensor:
    """The prototype's windowed form on the port's layout: feat
    (B, 1, H, W), offset (B, 2 K2, H, W) with channel 2k = dy, aff
    (B, K2, H, W) -> (B, 1, H, W); exact when every offset lies in
    [-radius, radius]. Plain PyTorch; autograd gives its backward."""
    _check_deformable(offset, aff, kernel)
    _, _, h, w = feat.shape
    rp = radius + 1 + kernel // 2
    p = F.pad(feat[:, 0], (rp, rp, rp, rp))
    out = torch.zeros_like(feat[:, 0])
    for k, (dy, dx) in enumerate(neighbor_shifts(kernel)):
        ty, tx = offset[:, 2 * k] + dy, offset[:, 2 * k + 1] + dx
        vs = range(dx - radius, dx + radius + 2)
        wxs = [tent(tx - v) for v in vs]
        acc = torch.zeros_like(out)
        for u in range(dy - radius, dy + radius + 2):
            wy = tent(ty - u)
            row = torch.zeros_like(out)
            for v, wx in zip(vs, wxs):
                row = row + p[:, rp + u:rp + u + h, rp + v:rp + v + w] * wx
            acc = acc + row * wy
        out = out + acc * aff[:, k]
    return out[:, None]


def main(device=None, shapes=SHAPES):
    """The probe along both axes, then per shape the prototype's largest
    error against ``propagate_deformable`` and, on the card, its device
    times (ms), forward and forward plus backward. Returns
    {"probe": {axis: equal}, (b, h, w): {...}}."""
    dev = resolve_device(device)
    print(f"device: {dev}", flush=True)
    x, idx = probe_inputs(dev)
    results = {"probe": {}}
    for axis in (0, 1):
        out = probe_gather(x, idx, axis)
        ref = torch.take_along_dim(x, torch.remainder(idx, x.shape[axis]).long(), axis)
        results["probe"][axis] = bool(torch.equal(out, ref))
        print(f"gather_probe(axis={axis}): OK, match: {results['probe'][axis]}",
              flush=True)

    for b, h, w in shapes:
        feat, off, aff = experiment_inputs(b, h, w, dev)
        ref = propagate_deformable(feat, off, aff, radius=RADIUS)
        row = {"max_err": (windowed_deform(feat, off, aff, radius=RADIUS) - ref)
               .abs().max().item()}
        line = f"{b}x{h}x{w} R={RADIUS}: max_err={row['max_err']:.2e}"
        if dev.type == "cuda":
            row["fwd_ms"] = 1e3 * measure(
                lambda: windowed_deform(feat, off, aff, radius=RADIUS), calls=2)
            leaves = [t.clone().requires_grad_(True) for t in (feat, off, aff)]

            def fwd_bwd():
                out = windowed_deform(*leaves, radius=RADIUS)
                return torch.autograd.grad((out * out).sum(), leaves)

            row["fwd_bwd_ms"] = 1e3 * measure(fwd_bwd, calls=2)
            line += (f" fwd {row['fwd_ms'] * 1e3:.0f}us; fwd+bwd "
                     f"{row['fwd_bwd_ms'] * 1e3:.0f}us")
        print(line, flush=True)
        results[(b, h, w)] = row
    return results


if __name__ == "__main__":
    main()
