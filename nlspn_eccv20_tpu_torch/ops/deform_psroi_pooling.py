"""Deformable position-sensitive RoI pooling, NCHW (op library).

Counterpart of ``nlspn_eccv20_tpu/ops/deform_psroi_pooling.py``, with the
reference CUDA kernel's layouts (``deform_psroi_pooling_cuda.cu``):

  data:  (B, C, H, W), C = output_dim group_size^2 in the order
         (output_dim, part row, part col)
  rois:  (N, 5) [batch index, x1, y1, x2, y2] in image coordinates
  trans: (N, 2, part, part) per-part offsets, channel 0 dy and channel 1 dx
         (the JAX package's order), scaled by trans_std and the roi's size
  out:   (N, output_dim, pooled_size, pooled_size)

A roi's corners are rounded half to even (``torch.round``, as
``jnp.round``), scaled by spatial_scale and moved by -0.5; its size is at
least 0.1. Each bin averages sample_per_part^2 bilinear samples of its own
part's channel block; samples outside [-0.5, size - 0.5] count as zero and
the mean divides by the number of samples inside. Plain PyTorch; its
backward is autograd (``torch.gather``'s gradient adds with atomics on the
card). Neither model routes through it.
"""

from __future__ import annotations

from typing import Optional

import torch


def _clip(t: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``, gradient included: half at an exact tie."""
    lo_t = torch.full((), lo, dtype=t.dtype, device=t.device)
    hi_t = torch.full((), hi, dtype=t.dtype, device=t.device)
    return torch.minimum(torch.maximum(t, lo_t), hi_t)


def deform_psroi_pooling(data: torch.Tensor, rois: torch.Tensor,
                         trans: Optional[torch.Tensor], *, spatial_scale: float,
                         output_dim: int, group_size: int, pooled_size: int,
                         part_size: Optional[int] = None,
                         sample_per_part: int = 4,
                         trans_std: float = 0.0) -> torch.Tensor:
    """Returns (N, output_dim, pooled_size, pooled_size)."""
    b, c, h, w = data.shape
    gs, ps, spp = group_size, pooled_size, sample_per_part
    if c != output_dim * gs * gs:
        raise ValueError(f"{c} channels, expected output_dim * group_size^2 = "
                         f"{output_dim * gs * gs}")
    n = rois.shape[0]
    part = part_size or ps
    dt, dev = data.dtype, data.device

    batch_idx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale - 0.5
    floor_ = torch.full((), 0.1, dtype=rois.dtype, device=dev)
    roi_w = torch.maximum(x2 - x1, floor_)
    roi_h = torch.maximum(y2 - y1, floor_)
    bin_w, bin_h = roi_w / ps, roi_h / ps
    sub_w, sub_h = bin_w / spp, bin_h / spp

    bi = torch.arange(ps, device=dev, dtype=dt).view(1, ps, 1)   # bin row
    bj = torch.arange(ps, device=dev, dtype=dt).view(1, 1, ps)   # bin col
    if trans is not None and trans_std > 0:
        ph = torch.floor(bi * part / ps).long().expand(n, ps, ps)
        pw = torch.floor(bj * part / ps).long().expand(n, ps, ps)
        nidx = torch.arange(n, device=dev).view(n, 1, 1).expand(n, ps, ps)
        off_y = trans[nidx, 0, ph, pw] * trans_std * roi_h.view(n, 1, 1)
        off_x = trans[nidx, 1, ph, pw] * trans_std * roi_w.view(n, 1, 1)
    else:
        off_y = off_x = torch.zeros((n, ps, ps), device=dev, dtype=dt)

    si = torch.arange(spp, device=dev, dtype=dt).view(spp, 1)
    sj = torch.arange(spp, device=dev, dtype=dt).view(1, spp)
    # (N, ps, ps, spp, spp) sampling coordinates
    sy = ((y1.view(n, 1, 1) + bi * bin_h.view(n, 1, 1) + off_y)[..., None, None]
          + (si + 0.5) * sub_h.view(n, 1, 1, 1, 1))
    sx = ((x1.view(n, 1, 1) + bj * bin_w.view(n, 1, 1) + off_x)[..., None, None]
          + (sj + 0.5) * sub_w.view(n, 1, 1, 1, 1))
    valid = (sy >= -0.5) & (sy <= h - 0.5) & (sx >= -0.5) & (sx <= w - 0.5)
    syc, sxc = _clip(sy, 0.0, h - 1.0), _clip(sx, 0.0, w - 1.0)

    # the part (channel block) each bin reads
    gh = torch.floor(bi * gs / ps).long().clamp(0, gs - 1)
    gw = torch.floor(bj * gs / ps).long().clamp(0, gs - 1)
    csel = (gh * gs + gw).view(1, ps, ps, 1, 1)

    y0, x0 = torch.floor(syc), torch.floor(sxc)
    ly, lx = (syc - y0)[:, None], (sxc - x0)[:, None]
    fmap = data[batch_idx].reshape(n, output_dim, gs * gs * h * w)
    m = ps * ps * spp * spp

    def corner(yc, xc):
        yi = yc.long().clamp(0, h - 1)
        xi = xc.long().clamp(0, w - 1)
        idx = (csel * h + yi) * w + xi                 # (N, ps, ps, spp, spp)
        vals = torch.gather(fmap, 2, idx.reshape(n, 1, m).expand(n, output_dim, m))
        return vals.view(n, output_dim, ps, ps, spp, spp)

    sample = (corner(y0, x0) * (1 - ly) * (1 - lx)
              + corner(y0, x0 + 1) * (1 - ly) * lx
              + corner(y0 + 1, x0) * ly * (1 - lx)
              + corner(y0 + 1, x0 + 1) * ly * lx)
    sample = torch.where(valid[:, None], sample, torch.zeros_like(sample))
    count = valid.sum((3, 4))[:, None].to(dt)          # (N, 1, ps, ps)
    return sample.sum((4, 5)) / torch.clamp_min(count, 1)
