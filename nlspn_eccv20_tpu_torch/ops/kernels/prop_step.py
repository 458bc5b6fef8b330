"""Kernel K1: one propagation step with its conf weighting, blend and clip.

Replaces the TPU kernel ``local_prop._step_kernel``
(``nlspn_eccv20_tpu/ops/pallas/local_prop.py``) and the elementwise work
around it. CUDA source: ``csrc/prop_step.cu``, whose header says what bounds
it on the card (memory: (K2 + 4) planes per step) and how it is laid out.

On a CPU tensor ``prop_step`` runs ``prop_step_plain``; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.propagate import propagate_local_planar

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"prop_step_f32": [_P] * 5 + [_I] * 6 + [_P]}


def prop_step_plain(pred: torch.Tensor, aff: torch.Tensor,
                    conf: Optional[torch.Tensor], dep: Optional[torch.Tensor],
                    *, kernel: int, preserve: bool, clip: bool) -> torch.Tensor:
    """``propagate_local_planar`` plus the blend and clip of the JAX
    package's ``_prop_and_blend`` (models/nlspn.py)."""
    feat = pred * conf if conf is not None else pred
    out = propagate_local_planar(feat, aff, kernel=kernel)
    if preserve:
        m = (dep > 0.0).to(out.dtype)
        out = (1.0 - m) * out + m * dep
    if clip:
        out = torch.clamp_min(out, 0.0)
    return out


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
    if pred.device.type == "cpu":
        return prop_step_plain(pred, aff, conf, dep, kernel=kernel,
                               preserve=preserve, clip=clip)
    b, h, w = pred.shape
    build.check_tensor(pred, "prop_step pred")
    build.check_tensor(aff, "prop_step aff", (b, kernel * kernel, h, w), pred.device)
    for name, t in (("conf", conf), ("dep", dep if preserve else None)):
        if t is not None:
            build.check_tensor(t, f"prop_step {name}", (b, h, w), pred.device)
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


prop_step.launches = 0
