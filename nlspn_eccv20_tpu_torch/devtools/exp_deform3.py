"""Kernel K10b: the column-exact, row-windowed deformable gather, and the
experiment that times it.

Counterpart of the JAX package's ``devtools/exp_deform3.py``: K10b
(``csrc/deform_colgather.cu``) replaces its TPU kernel ``_kernel`` (reached
from ``deform_pallas``). For each neighbour k of the 3x3 stencil, with
ty = oy_k + dy_k and tx = ox_k + dx_k, the column is resolved exactly by
the two taps at floor(tx) and floor(tx) + 1, the rows by the static tent
window u in [dy_k - R, dy_k + R + 1]:

    n_k = sum_u tent(ty - u) * (P(y+u, x+x0) * (1 - fx) + P(y+u, x+x0+1) * fx)
    out = sum_k aff_k * n_k

on the plane P zero-padded by R + 2: the exact gather when every offset
lies in [-R, R]. A column tap outside the padded row is zero (the TPU's
lane gather has no such row). 3x3 only: the TPU kernel's padding of R + 2
is one row short for a 5x5 stencil's shift of 2, so other kernels raise.
Forward only, as the TPU prototype.

What bounds it on the card: its bytes, 116 a pixel (the plane, 27 offset
and affinity planes, the output). The TPU kernel walks all 2R + 2 rows of
the window (it had sublane shifts and no gather), which on the card is
bound by instruction issue. The tent is non-zero on two rows at most,
floor(ty) and floor(ty) + 1, so the kernel sums only those that lie in the
window, with the plain version's own weight expression and in its order:
the same bits for any finite plane (``deform_colgather_two_rows`` is that
arithmetic in PyTorch, for the CPU tests). A thread owns 4 pixels of a row
and reads the 27 planes as 16-byte loads where W % 4 == 0; a block stages
its 16 x 64 tile of the plane and the halo by cp.async (``colgather_map``
mirrors the pixel-to-thread map).

``main()`` runs the TPU experiment's comparison at NYU b=12 of 228x304 and
KITTI b=1 of 240x1216 with offsets clip(N(0, 1.5^2), -4, 4): K10b's largest
error against the exact gather, and the device times of K10b, the plain
windowed form and K7 (``deform_prop``, the exact gather the model runs).
It needs the card unless it is given ``device="cpu"`` (then no times).
``deform_colgather_case`` builds the same kind of inputs from a seeded
generator for ``tools/profile_kernels.py`` (``experiment_case``, which
K10a's case shares).

    python -m nlspn_eccv20_tpu_torch.devtools.exp_deform3
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.device import resolve_device
from nlspn_eccv20_tpu_torch.devtools.measure import measure
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import deform_prop, sampling_grid
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import case_rng
from nlspn_eccv20_tpu_torch.ops.propagate import (
    neighbor_shifts,
    propagate_deformable_exact_planar,
    propagate_deformable_windowed_planar,
    tent,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"deform_colgather_f32": [_P] * 4 + [_I] * 4 + [_P]}
SHAPES = ((12, 228, 304), (1, 240, 1216))   # NYU train batch, KITTI b=1
RADIUS = 4
# csrc/deform_colgather.cu's layout: a thread's pixels along a row, a
# block's tile (rows, columns) and its threads
COLGATHER_PX, COLGATHER_TILE, COLGATHER_THREADS = 4, (16, 64), 256


def _check(feat, off, aff, kernel, radius):
    if kernel != 3:
        raise ValueError(f"deform_colgather is 3x3 only, got kernel {kernel}")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    b, h, w = feat.shape
    if off.shape != (b, 18, h, w) or aff.shape != (b, 9, h, w):
        raise ValueError(f"off {tuple(off.shape)} and aff {tuple(aff.shape)} "
                         f"do not fit feat {tuple(feat.shape)}")


def deform_colgather_plain(feat: torch.Tensor, off: torch.Tensor, aff: torch.Tensor,
                           radius: int = 4) -> torch.Tensor:
    """K10b's function in the TPU kernel's order: feat (B, H, W), off
    (B, 18, H, W) with channel 2k = dy, aff (B, 9, H, W) -> (B, H, W)."""
    _check(feat, off, aff, 3, radius)
    b, h, w = feat.shape
    rp = radius + 2
    p = F.pad(feat, (rp, rp, rp, rp))
    w2 = w + 2 * rp
    cols = torch.arange(w, device=feat.device).view(1, 1, w)
    acc = torch.zeros_like(feat)
    for k, (dy, dx) in enumerate(neighbor_shifts(3)):
        ty, tx = off[:, 2 * k] + dy, off[:, 2 * k + 1] + dx
        a = aff[:, k]
        x0f = torch.floor(tx)
        fx = tx - x0f
        # the left tap's column in the padded row; clamped first, so that
        # any finite offset lands outside the row
        xi = cols + torch.clamp(x0f, -w2, w2).long() + rp
        taps = []
        for xj in (xi, xi + 1):
            valid = (xj >= 0) & (xj < w2)
            taps.append((xj.clamp(0, w2 - 1), valid))
        neighk = torch.zeros_like(feat)
        for u in range(dy - radius, dy + radius + 2):
            rowblk = p[:, rp + u:rp + u + h]
            g0, g1 = (torch.where(valid, torch.gather(rowblk, 2, xj),
                                  torch.zeros_like(feat)) for xj, valid in taps)
            wy = tent(ty - u)
            neighk = neighk + wy * (g0 * (1.0 - fx) + g1 * fx)
        acc = acc + a * neighk
    return acc


def deform_colgather_two_rows(feat: torch.Tensor, off: torch.Tensor, aff: torch.Tensor,
                              radius: int = 4) -> torch.Tensor:
    """K10b's arithmetic as ``csrc/deform_colgather.cu`` does it, for the
    CPU tests: per neighbour only the tent's rows u0 = floor(ty) (clamped
    to +-(R + 3)) and u0 + 1, each where it lies in the window, added in
    that order to a sum that starts at +0, each weight ``tent(ty - u)``;
    the column taps, their zeros outside the image and the sum over the
    neighbours as ``deform_colgather_plain``. Equal bits to it for any
    finite plane."""
    _check(feat, off, aff, 3, radius)
    b, h, w = feat.shape
    flat = feat.reshape(b, h * w)
    rows = torch.arange(h).view(1, h, 1)
    cols = torch.arange(w).view(1, 1, w)
    acc = torch.zeros_like(feat)
    for k, (dy, dx) in enumerate(neighbor_shifts(3)):
        ty, tx = off[:, 2 * k] + dy, off[:, 2 * k + 1] + dx
        a = aff[:, k]
        x0f = torch.floor(tx)
        fx = tx - x0f
        c = cols + torch.clamp(x0f, -(w + 2), w + 2).long()
        u0 = torch.clamp(torch.floor(ty), -(radius + 3), radius + 3).long()
        neighk = torch.zeros_like(feat)
        for r in (0, 1):
            u = u0 + r
            yy = rows + u
            g = []
            for xx in (c, c + 1):
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).view(b, -1)
                g.append(torch.where(ok, torch.gather(flat, 1, idx).view(b, h, w),
                                     torch.zeros_like(feat)))
            term = tent(ty - u.float()) * (g[0] * (1.0 - fx) + g[1] * fx)
            in_window = (u >= dy - radius) & (u <= dy + radius + 1)
            neighk = torch.where(in_window, neighk + term, neighk)
        acc = acc + a * neighk
    return acc


def colgather_map(h: int, w: int):
    """K10b's pixel-to-thread map on one image: {(block row, block column,
    thread): [(y, x), ...]}, the pixels each thread computes (none for a
    thread past the image), as ``csrc/deform_colgather.cu`` lays them out."""
    th, tw = COLGATHER_TILE
    per_row = tw // COLGATHER_PX
    out = {}
    for by in range(-(-h // th)):
        for bx in range(-(-w // tw)):
            for t in range(COLGATHER_THREADS):
                y = by * th + t // per_row
                xs = bx * tw + COLGATHER_PX * (t % per_row)
                out[(by, bx, t)] = [(y, x) for x in range(xs, xs + COLGATHER_PX)
                                    if y < h and x < w]
    return out


def deform_colgather(feat: torch.Tensor, off: torch.Tensor, aff: torch.Tensor,
                     radius: int = 4) -> torch.Tensor:
    """K10b on planar tensors (as ``deform_colgather_plain``). On a CPU
    tensor it runs the plain version; on a CUDA tensor it launches the
    kernel or raises."""
    if feat.device.type == "cpu":
        return deform_colgather_plain(feat, off, aff, radius)
    _check(feat, off, aff, 3, radius)
    b, h, w = feat.shape
    build.check_tensor(feat, "deform_colgather feat")
    build.check_tensor(off, "deform_colgather off", device=feat.device)
    build.check_tensor(aff, "deform_colgather aff", device=feat.device)
    out = torch.empty_like(feat)
    with torch.cuda.device(feat.device):
        lib = build.load("deform_colgather", _SIGNATURES)
        err = lib.deform_colgather_f32(
            feat.data_ptr(), off.data_ptr(), aff.data_ptr(), out.data_ptr(),
            b, h, w, radius, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "deform_colgather")
    deform_colgather.launches += 1
    return out


deform_colgather.launches = 0


def deform_pallas(feat: torch.Tensor, offset: torch.Tensor, aff: torch.Tensor,
                  kernel: int = 3, radius: int = 4) -> torch.Tensor:
    """The JAX prototype's ``deform_pallas`` on the port's layout: feat
    (B, 1, H, W), offset (B, 18, H, W), aff (B, 9, H, W) -> (B, 1, H, W)."""
    if feat.shape[1] != 1:
        raise ValueError(f"feat has {feat.shape[1]} channels, want 1")
    if kernel != 3:
        raise ValueError(f"deform_pallas is 3x3 only, got kernel {kernel}")
    return deform_colgather(feat[:, 0].contiguous(), offset.contiguous(),
                            aff.contiguous(), radius)[:, None]


def experiment_inputs(b, h, w, device, seed=0):
    """The JAX experiment's inputs, drawn in its NHWC order from one numpy
    generator and moved to the port's layout: feat N(0, 1), offsets
    clip(N(0, 1.5^2), -4, 4), affinities N(0, 0.11^2)."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, h, w, 1)).astype(np.float32)
    off = np.clip(rng.standard_normal((b, h, w, 18)) * 1.5, -4, 4).astype(np.float32)
    aff = (rng.standard_normal((b, h, w, 9)) * 0.11).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)
                 for a in (feat, off, aff))


def experiment_case(gen: torch.Generator, device, b: int, h: int, w: int,
                    kernel: int = 3):
    """The experiment's kind of inputs for a ``kernel`` x ``kernel``
    stencil, from ``gen``: feat N(0, 1), offsets clip(N(0, 1.5^2), -4, 4),
    affinities N(0, 0.11^2), drawn with numpy (``case_rng``). Returns
    ((feat, off, aff), library): the library call is the exact gather
    through ``F.grid_sample`` over the stacked sampling grids and the
    weighted sum, which the port never calls."""
    k2 = kernel * kernel
    rng = case_rng(gen)
    feat = rng.standard_normal((b, h, w)).astype(np.float32)
    off = np.clip(rng.standard_normal((b, 2 * k2, h, w)) * 1.5, -4, 4).astype(np.float32)
    aff = (rng.standard_normal((b, k2, h, w)) * 0.11).astype(np.float32)
    feat, off, aff = (torch.from_numpy(a).to(device) for a in (feat, off, aff))
    shifts = torch.tensor(neighbor_shifts(kernel), device=device, dtype=torch.float32)

    def library():
        smp = F.grid_sample(feat[:, None], sampling_grid(off, shifts), mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        return (smp.view(b, k2, h, w) * aff).sum(1)

    return (feat, off, aff), library


def deform_colgather_case(gen: torch.Generator, device, b: int, h: int, w: int):
    """Inputs on which K10b is timed on the card, from ``gen``
    (``experiment_case``, 3x3). Returns ((feat, off, aff, RADIUS),
    library)."""
    (feat, off, aff), library = experiment_case(gen, device, b, h, w)
    return (feat, off, aff, RADIUS), library


def main(device=None, shapes=SHAPES):
    """Per shape: K10b's largest error against the exact gather and, on
    the card, the device times (ms) of K10b, the plain windowed form and K7.
    Returns {(b, h, w): {...}}."""
    dev = resolve_device(device)
    print(f"device: {dev}", flush=True)
    results = {}
    for b, h, w in shapes:
        feat, off, aff = experiment_inputs(b, h, w, dev)
        f = feat[:, 0]
        ref = propagate_deformable_exact_planar(f, off, aff)
        out = deform_pallas(feat, off, aff, radius=RADIUS)
        row = {"max_err": (out[:, 0] - ref).abs().max().item()}
        line = f"{b}x{h}x{w} colgather: max_err={row['max_err']:.2e}"
        if dev.type == "cuda":
            row["ms"] = 1e3 * measure(lambda: deform_pallas(feat, off, aff, radius=RADIUS))
            row["windowed_plain_ms"] = 1e3 * measure(
                lambda: propagate_deformable_windowed_planar(f, off, aff, 3, RADIUS),
                calls=2)
            row["k7_ms"] = 1e3 * measure(lambda: deform_prop(f, off, aff, kernel=3))
            line += (f" fwd {row['ms'] * 1e3:.1f}us; plain windowed "
                     f"{row['windowed_plain_ms'] * 1e3:.0f}us; K7 deform_prop "
                     f"{row['k7_ms'] * 1e3:.1f}us")
        print(line, flush=True)
        results[(b, h, w)] = row
    return results


if __name__ == "__main__":
    main()
