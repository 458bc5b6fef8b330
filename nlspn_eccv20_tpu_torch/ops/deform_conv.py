"""Deformable convolution, DCN v1 and v2, NCHW (op library).

Counterpart of ``nlspn_eccv20_tpu/ops/deform_conv.py``, with the reference
CUDA extension's tensor layouts (``modulated_deform_conv_cuda.cu``):

  x:      (B, C, H, W)
  offset: (B, 2 dg K2, Ho, Wo)  channel 2 (g K2 + k) is the dy of
          deformable group g and kernel tap k, the next one its dx (the
          JAX package's pair order)
  mask:   (B, dg K2, Ho, Wo)    DCN v2 modulation, None for v1
  weight: (Cout, C / groups, kh, kw), torch's Conv2d layout

Each tap samples the input bilinearly at

    y = ho stride - padding + ky dilation + dy,
    x = wo stride - padding + kx dilation + dx,

each of the four corners zero outside the image. The contraction over
(C / groups) K2 is a ``torch.matmul``, as the JAX package leaves its
``dot_general`` to XLA. The backward is autograd: on the card the gradient
of ``torch.gather`` scatters with atomic adds, so d_x may differ in the last
bits from run to run (the JAX package's scatter-add is deterministic).
Neither model routes through it: NLSPN's propagation uses the degenerate
all-ones-weight case (``ops/propagate.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _out_size(size: int, k: int, stride: int, pad: int, dilation: int) -> int:
    return (size + 2 * pad - ((k - 1) * dilation + 1)) // stride + 1


def deformable_im2col(x: torch.Tensor, offset: torch.Tensor,
                      mask: Optional[torch.Tensor], kernel: Tuple[int, int],
                      stride: int = 1, padding: int = 0, dilation: int = 1,
                      deformable_groups: int = 1) -> torch.Tensor:
    """Bilinear-gather im2col: columns (B, C, K2, Ho, Wo), the reference's
    column order (channel-major, then kernel tap ky kw + kx)."""
    b, c, h, w = x.shape
    kh, kw = kernel
    k2, dg = kh * kw, deformable_groups
    if c % dg:
        raise ValueError(f"{c} channels do not divide into {dg} deformable groups")
    cg = c // dg
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    off = offset.reshape(b, dg, k2, 2, ho, wo)

    kidx = torch.arange(k2, device=x.device)
    ky = (kidx // kw).to(x.dtype).view(1, 1, k2, 1, 1)
    kx = (kidx % kw).to(x.dtype).view(1, 1, k2, 1, 1)
    oy = torch.arange(ho, device=x.device, dtype=x.dtype).view(1, 1, 1, ho, 1)
    ox = torch.arange(wo, device=x.device, dtype=x.dtype).view(1, 1, 1, 1, wo)
    # the JAX package's order of operations, so that both floor alike
    sy = oy * stride - padding + ky * dilation + off[:, :, :, 0]
    sx = ox * stride - padding + kx * dilation + off[:, :, :, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0

    flat = x.reshape(b, dg, cg, h * w)
    n = k2 * ho * wo

    def corner(yc, xc, wy, wx):
        valid = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
        vals = torch.gather(flat, 3, idx.reshape(b, dg, 1, n).expand(b, dg, cg, n))
        wgt = valid.to(x.dtype) * wy * wx
        return vals.view(b, dg, cg, k2, ho, wo) * wgt.view(b, dg, 1, k2, ho, wo)

    cols = (corner(y0, x0, 1.0 - ly, 1.0 - lx)
            + corner(y0, x0 + 1.0, 1.0 - ly, lx)
            + corner(y0 + 1.0, x0, ly, 1.0 - lx)
            + corner(y0 + 1.0, x0 + 1.0, ly, lx))
    if mask is not None:
        cols = cols * mask.reshape(b, dg, 1, k2, ho, wo)
    return cols.reshape(b, c, k2, ho, wo)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, stride: int = 1,
                          padding: int = 0, dilation: int = 1, groups: int = 1,
                          deformable_groups: int = 1) -> torch.Tensor:
    """DCN v2 forward (v1 when mask is None). x (B, C, H, W); weight
    (Cout, C / groups, kh, kw). Returns (B, Cout, Ho, Wo)."""
    cout, cin_g, kh, kw = weight.shape
    c = x.shape[1]
    if c != cin_g * groups:
        raise ValueError(f"x has {c} channels, the weight expects {cin_g * groups}")
    cols = deformable_im2col(x, offset, mask, (kh, kw), stride, padding,
                             dilation, deformable_groups)
    b, _, k2, ho, wo = cols.shape
    lhs = cols.reshape(b, groups, cin_g * k2, ho * wo)
    rhs = weight.reshape(groups, cout // groups, cin_g * k2)
    out = torch.matmul(rhs, lhs).reshape(b, cout, ho, wo)
    if bias is not None:
        out = out + bias.view(1, cout, 1, 1)
    return out


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0, dilation: int = 1, groups: int = 1,
                deformable_groups: int = 1) -> torch.Tensor:
    """DCN v1: the deformable conv without modulation."""
    return modulated_deform_conv(x, offset, None, weight, bias, stride, padding,
                                 dilation, groups, deformable_groups)
