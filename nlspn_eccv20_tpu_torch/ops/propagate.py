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
  (train: offsets clamped to [-R, R], then the windowed form; eval, and
  training with R = 0: the exact gather).

* ``propagate_deformable_windowed_union``: the windowed form re-associated
  over the union of global shifts (one weight field a shift), the JAX
  package's equivalence primitive of the same name; no model runs it.

The JAX package's scan variant of the windowed form is a code generation
choice of XLA with the same math and has no counterpart here.
Offsets are planar (B, 2 * K2, H, W), the (dy, dx) pair of neighbour k at
channels (2k, 2k + 1).

The op library's entry points, on NCHW tensors (feat (B, 1, H, W), aff
(B, K2, H, W), offset (B, 2 K2, H, W)): ``propagate_local``,
``propagate_deformable`` and ``propagate_step``. Their ``impl`` keeps the
JAX package's meaning: ``'xla'`` and ``'auto'`` run the plain PyTorch forms
above, as the JAX package runs its XLA forms at op level; ``'pallas'`` runs
the kernel wrappers, which launch K1 (``prop_step``) or K7
(``deform_prop``) on a CUDA tensor or raise, and run their plain versions
on a CPU tensor.
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


def propagate_deformable_windowed_union(feat: torch.Tensor, offset: torch.Tensor,
                                        aff: torch.Tensor, kernel: int = 3,
                                        radius: int = 4) -> torch.Tensor:
    """The windowed form re-associated over the union of global shifts, as
    the JAX op of this name: each neighbour's affinity-scaled tent products
    are summed into one weight field per global shift (U, V), and the plane
    is shifted once per (U, V), (2R + 2 (k // 2) + 2)^2 times, instead of
    once per neighbour and window cell. The same values as
    ``propagate_deformable_windowed_planar`` up to f32 sum order. The JAX
    package measured it slower than the unrolled form on the TPU and keeps
    it as an equivalence-tested primitive; the port has no kernel for it.

    feat (B, 1, H, W), offset (B, 2 K2, H, W), aff (B, K2, H, W) -> (B, 1, H, W).
    """
    if feat.shape[1] != 1:
        raise ValueError(f"feat has {feat.shape[1]} channels, want 1")
    _check_deformable(offset, aff, kernel)
    _, _, h, w = feat.shape
    kc = kernel // 2
    rp = radius + 1 + kc
    p = F.pad(feat[:, 0], (rp, rp, rp, rp))
    shifts = neighbor_shifts(kernel)
    wy, wx = {}, {}   # per-neighbour 1-D tent terms, the affinity in the row's
    for k, (dy, dx) in enumerate(shifts):
        ty, tx, a = offset[:, 2 * k] + dy, offset[:, 2 * k + 1] + dx, aff[:, k]
        for u in range(dy - radius, dy + radius + 2):
            wy[k, u] = a * tent(ty - u)
        for v in range(dx - radius, dx + radius + 2):
            wx[k, v] = tent(tx - v)
    out = torch.zeros_like(feat[:, 0])
    for u in range(-radius - kc, radius + kc + 2):
        for v in range(-radius - kc, radius + kc + 2):
            terms = [wy[k, u] * wx[k, v] for k in range(len(shifts))
                     if (k, u) in wy and (k, v) in wx]
            if not terms:
                continue
            field = terms[0]
            for t in terms[1:]:
                field = field + t
            out = out + p[:, rp + u:rp + u + h, rp + v:rp + v + w] * field
    return out[:, None]


def clamp_offsets(off: torch.Tensor, radius: int) -> torch.Tensor:
    """Offsets clamped to [-radius, radius] as ``jnp.clip`` does, also in
    the gradient: half at exactly +-radius, none beyond: what training runs
    the windowed form on (radius >= 1; a window of 0 clamps nothing, see
    ``propagate_deformable_planar``)."""
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
    computes too. ``radius`` 0 or None means the exact gather, unclamped,
    in training too (the JAX package's ``radius=None``), whose autograd
    gives the floor-based bilinear gradients."""
    if train and radius:
        return propagate_deformable_windowed_planar(
            feat, clamp_offsets(off, radius), aff, kernel, radius)
    return propagate_deformable_exact_planar(feat, off, aff, kernel)


def propagate_local(feat: torch.Tensor, aff: torch.Tensor,
                    kernel: int = 3) -> torch.Tensor:
    """feat (B, 1, H, W), aff (B, K2, H, W) -> (B, 1, H, W):
    ``propagate_local_planar`` of the one channel."""
    if feat.shape[1] != 1:
        raise ValueError(f"feat has {feat.shape[1]} channels, want 1")
    return propagate_local_planar(feat[:, 0], aff, kernel=kernel)[:, None]


def propagate_deformable(feat: torch.Tensor, offset: torch.Tensor,
                         aff: torch.Tensor, kernel: int = 3,
                         radius: Optional[int] = 4, impl: str = "auto",
                         fallback: bool = True) -> torch.Tensor:
    """One deformable step, feat (B, 1, H, W) -> (B, 1, H, W), as the JAX
    package's ``propagate_deformable``:

    * ``fallback=False`` (training): offsets clamped to [-radius, radius],
      then the window form, whose backward has the window's tie rules;
    * ``fallback=True`` (inference): the JAX op's ``lax.cond`` takes its
      window form when every offset lies in [-radius, radius] and the exact
      gather otherwise. The values are equal; the gradients differ where an
      offset is an integer. So under autograd this op makes the same test
      (one host sync) and differentiates the window form inside the window;
      without autograd, and beyond the window, it runs the exact gather;
    * ``radius`` None: the exact gather, whose backward is its own VJP.

    ``impl='pallas'`` runs K7 (``deform_prop``) on the same offsets: with a
    window, K8 is its backward; for the exact gather the backward is
    ``deform_prop_exact_bwd_plain``, plain PyTorch on the card too."""
    if feat.shape[1] != 1:
        raise ValueError(f"feat has {feat.shape[1]} channels, want 1")
    if impl not in ("pallas", "xla", "auto"):
        raise ValueError(f"unknown impl {impl}")
    f = feat[:, 0]
    window = radius
    if radius is not None and fallback:
        recording = torch.is_grad_enabled() and any(
            t.requires_grad for t in (feat, offset, aff))
        if not (recording and bool(offset.abs().max() <= radius)):
            window = None
    off = offset if window is None or fallback else clamp_offsets(offset, window)
    if impl == "pallas":
        # imported here: the kernel modules import this one
        from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import deform_prop

        return deform_prop(f.contiguous(), off.contiguous(), aff.contiguous(),
                           kernel=kernel, radius=window)[:, None]
    if window is None:
        return propagate_deformable_exact_planar(f, off, aff, kernel)[:, None]
    return propagate_deformable_windowed_planar(f, off, aff, kernel, window)[:, None]


def propagate_step(feat: torch.Tensor, aff: torch.Tensor,
                   offset: Optional[torch.Tensor] = None, kernel: int = 3,
                   impl: str = "auto", radius: Optional[int] = 4) -> torch.Tensor:
    """One propagation step, (B, 1, H, W): deformable when ``offset`` is
    given (``propagate_deformable`` with its inference fallback), else
    local; ``impl`` as the module docstring says."""
    if offset is not None:
        return propagate_deformable(feat, offset, aff, kernel=kernel,
                                    radius=radius, impl=impl)
    if impl in ("xla", "auto"):
        return propagate_local(feat, aff, kernel=kernel)
    if impl == "pallas":
        from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import prop_step

        if feat.shape[1] != 1:
            raise ValueError(f"feat has {feat.shape[1]} channels, want 1")
        return prop_step(feat[:, 0].contiguous(), aff.contiguous(),
                         kernel=kernel)[:, None]
    raise ValueError(f"unknown impl {impl}")
