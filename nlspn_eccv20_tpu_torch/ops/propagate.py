"""Spatial propagation, plain PyTorch on planar tensors (the oracles of the
``prop_step`` and ``deform_prop`` kernels).

Counterpart of ``nlspn_eccv20_tpu/ops/propagate.py``:

* ``propagate_local_planar`` (reference ``_propagate_once``, no-offset
  branch): replicate-pad the depth plane and sum the k*k shifted
  neighbours, each weighted by its affinity plane.
* ``propagate_deformable_exact_planar`` (the ``--offset`` path): each
  neighbour is a bilinear sample at its kernel shift plus a learned offset,
  zero outside the image (DCNv2's semantics).
* ``propagate_deformable_windowed_planar``: the same sample written as a
  tent-weighted sum over the window u, v in [-R, R + 1] around the kernel
  shift, equal to the exact gather for offsets in [-R, R]. Its autograd
  gives the JAX package's gradients, ties included.
* ``propagate_deformable_planar``: the JAX package's router between them
  (train: offsets clamped to [-R, R], then the windowed form; eval: the
  exact gather).

The JAX package's scan and union variants of the windowed form are code
generation choices of XLA with the same math and have no counterpart here.
Offsets are planar (B, 2 * K2, H, W), the (dy, dx) pair of neighbour k at
channels (2k, 2k + 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def neighbor_shifts(kernel: int):
    """Row-major (dy, dx) shifts of a kernel x kernel stencil, center included."""
    r = kernel // 2
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def propagate_local_planar(p: torch.Tensor, aff: torch.Tensor,
                           kernel: int = 3) -> torch.Tensor:
    """p: (B, H, W) plane (already confidence-weighted by the caller);
    aff: (B, K2, H, W), K2 = kernel**2, row-major neighbor order with the
    center at K2 // 2. Returns (B, H, W)."""
    if kernel % 2 != 1:
        raise ValueError(f"kernel must be odd, got {kernel}")
    if aff.shape[1] != kernel * kernel:
        raise ValueError(f"aff has {aff.shape[1]} channels, want {kernel * kernel}")
    _, h, w = p.shape
    r = kernel // 2
    padded = F.pad(p[:, None], (r, r, r, r), mode="replicate")[:, 0]
    out = torch.zeros_like(p)
    for idx, (dy, dx) in enumerate(neighbor_shifts(kernel)):
        window = padded[:, dy + r:dy + r + h, dx + r:dx + r + w]
        out = out + window * aff[:, idx]
    return out


def _check_deformable(off, aff, kernel):
    k2 = kernel * kernel
    if kernel % 2 != 1:
        raise ValueError(f"kernel must be odd, got {kernel}")
    if aff.shape[1] != k2 or off.shape[1] != 2 * k2:
        raise ValueError(f"aff has {aff.shape[1]} and off {off.shape[1]} "
                         f"channels, want {k2} and {2 * k2}")


def bilinear_sample(flat: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                    dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """Bilinear sample of the (B, H*W) plane ``flat`` at (y + dy + oy,
    x + dx + ox) for every pixel (y, x), zero outside the image.

    The fraction is taken of the offset alone (oy - floor(oy)), not of the
    absolute coordinate, so it keeps the offset's precision at any y. Far
    corners are clamped to just outside the image before the integer
    conversion, so an unbounded offset reads zeros. The four products are
    added in the order of ``csrc/deform_common.cuh``."""
    b = flat.shape[0]
    fy, fx = torch.floor(oy), torch.floor(ox)
    ly, lx = oy - fy, ox - fx
    hy, hx = 1.0 - ly, 1.0 - lx
    ys = torch.arange(h, device=flat.device, dtype=oy.dtype).view(1, h, 1)
    xs = torch.arange(w, device=flat.device, dtype=oy.dtype).view(1, 1, w)
    y0 = torch.clamp(ys + dy + fy, -2, h).long()
    x0 = torch.clamp(xs + dx + fx, -2, w).long()

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx.reshape(b, -1)).view_as(oy)
        return torch.where(valid, vals, torch.zeros_like(vals))

    return (hy * hx * tap(y0, x0) + hy * lx * tap(y0, x0 + 1)
            + ly * hx * tap(y0 + 1, x0) + ly * lx * tap(y0 + 1, x0 + 1))


def propagate_deformable_exact_planar(feat: torch.Tensor, off: torch.Tensor,
                                      aff: torch.Tensor,
                                      kernel: int = 3) -> torch.Tensor:
    """feat: (B, H, W); off: (B, 2*K2, H, W); aff: (B, K2, H, W).
    Returns sum_k aff_k * bilinear(feat, y + dy_k + oy_k, x + dx_k + ox_k),
    (B, H, W), zero outside the image, for any offsets. Autograd through it
    gives the floor-based gradients of bilinear sampling."""
    _check_deformable(off, aff, kernel)
    b, h, w = feat.shape
    flat = feat.reshape(b, h * w)
    out = torch.zeros_like(feat)
    for k, (dy, dx) in enumerate(neighbor_shifts(kernel)):
        s = bilinear_sample(flat, off[:, 2 * k], off[:, 2 * k + 1], dy, dx, h, w)
        out = out + s * aff[:, k]
    return out


def tent(t: torch.Tensor) -> torch.Tensor:
    """max(0, 1 - |t|) with JAX's tie conventions under autograd: d|t|/dt
    is +1 at t == 0 (``where``, not ``torch.abs``) and ``torch.maximum``
    passes half the gradient at |t| == 1."""
    az = torch.where(t >= 0, t, -t)
    one_minus = 1.0 - az
    return torch.maximum(one_minus, torch.zeros_like(one_minus))


def propagate_deformable_windowed_planar(feat: torch.Tensor, off: torch.Tensor,
                                         aff: torch.Tensor, kernel: int = 3,
                                         radius: int = 4) -> torch.Tensor:
    """The tent-weighted window form of the deformable step:
    out_k(y, x) = sum_{u, v in [-R, R+1]} tent(oy_k - u) * tent(ox_k - v)
    * P(y + dy_k + u, x + dx_k + v), zero-padded P. Equal to the exact
    gather for offsets in [-R, R]; beyond, the window truncates it."""
    _check_deformable(off, aff, kernel)
    _, h, w = feat.shape
    rp = radius + 1 + kernel // 2
    p = F.pad(feat, (rp, rp, rp, rp))
    window = range(-radius, radius + 2)
    out = torch.zeros_like(feat)
    for k, (dy, dx) in enumerate(neighbor_shifts(kernel)):
        oy, ox = off[:, 2 * k], off[:, 2 * k + 1]
        wxs = [tent(ox - v) for v in window]
        acc = torch.zeros_like(feat)
        for u in window:
            row = torch.zeros_like(feat)
            for v, wx in zip(window, wxs):
                y0, x0 = rp + dy + u, rp + dx + v
                row = row + p[:, y0:y0 + h, x0:x0 + w] * wx
            acc = acc + row * tent(oy - u)
        out = out + acc * aff[:, k]
    return out


def clamp_offsets(off: torch.Tensor, radius: Optional[int]) -> torch.Tensor:
    """Offsets clamped to [-radius, radius] as ``jnp.clip`` does, also in
    the gradient: half at exactly +-radius, none beyond: what training runs
    the windowed form on. ``radius`` 0 or None means the exact gather, whose
    training is not ported yet (ROADMAP): it raises."""
    if not radius:
        raise NotImplementedError(
            "offset_window=0 (the exact gather) in training is not ported "
            "yet: see ROADMAP.md, the --offset slice's open items")
    lo = torch.full((), -float(radius), dtype=off.dtype, device=off.device)
    return torch.minimum(torch.maximum(off, lo), -lo)


def propagate_deformable_planar(feat: torch.Tensor, off: torch.Tensor,
                                aff: torch.Tensor, kernel: int = 3,
                                radius: Optional[int] = 4,
                                train: bool = False) -> torch.Tensor:
    """One deformable step with the JAX package's semantics
    (``propagate_deformable``): training clamps the offsets to
    [-radius, radius] and runs the windowed form; eval runs the exact
    gather, which the JAX package's runtime switch between its windowed
    form (offsets inside the window) and its exact gather (offsets beyond)
    computes too. ``radius`` 0 or None means the exact gather; training
    with it is not ported yet (ROADMAP) and raises."""
    if train:
        return propagate_deformable_windowed_planar(
            feat, clamp_offsets(off, radius), aff, kernel, radius)
    return propagate_deformable_exact_planar(feat, off, aff, kernel)
