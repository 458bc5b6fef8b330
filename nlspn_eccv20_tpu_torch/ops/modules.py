"""``nn.Module`` wrappers over the deformable op library, NCHW.

Counterpart of ``nlspn_eccv20_tpu/ops/modules.py`` (the reference's
``deformconv/modules``): ``DeformConv[Pack]``, ``ModulatedDeformConv[Pack]``
and ``DeformRoIPooling[Pack]``. The Pack variants make their own offsets
(and masks) with a zero-initialised layer, so at init they equal their
non-deformable counterparts: a ``DeformConvPack`` a plain conv, a
``ModulatedDeformConvPack`` half the conv plus its bias (mask
sigmoid(0) = 0.5), a ``DeformRoIPoolingPack`` half the plain PS-RoI pooling.

The constructors take ``in_channels``, as the reference's do, because torch
makes its parameters when the module is built; the other arguments keep the
JAX package's names and defaults. Weights are U(-1/sqrt(fan_in),
1/sqrt(fan_in)) drawn from ``generator`` (a CPU ``torch.Generator``; a fresh
seed-0 one when None), biases zero, the offset and mask generators
(``conv_offset``, ``conv_offset_mask``, ``fc_offset``) zero.
``utils.weights.from_jax_op_variables`` loads the JAX modules' variables.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nlspn_eccv20_tpu_torch.ops.deform_conv import modulated_deform_conv
from nlspn_eccv20_tpu_torch.ops.deform_psroi_pooling import deform_psroi_pooling


def _uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = fan_in ** -0.5
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)


class DeformConv(nn.Module):
    """DCN v1: forward(x, offset)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 groups: int = 1, deformable_groups: int = 1,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_channels % groups:
            raise ValueError(f"{in_channels} channels do not divide into {groups} groups")
        self.in_channels, self.features, self.kernel = in_channels, features, kernel
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.deformable_groups = groups, deformable_groups
        cin_g = in_channels // groups
        self.weight = nn.Parameter(torch.empty(features, cin_g, kernel, kernel))
        _uniform_(self.weight, cin_g * kernel * kernel,
                  generator or torch.Generator().manual_seed(0))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _offset_conv(self, n_out: int) -> nn.Conv2d:
        conv = nn.Conv2d(self.in_channels, n_out, self.kernel, self.stride,
                         self.padding, self.dilation)
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
        return conv

    def _conv(self, x, offset, mask=None):
        return modulated_deform_conv(
            x, offset, mask, self.weight, self.bias, stride=self.stride,
            padding=self.padding, dilation=self.dilation, groups=self.groups,
            deformable_groups=self.deformable_groups)

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        return self._conv(x, offset)


class DeformConvPack(DeformConv):
    """DCN v1 with offsets from a zero-initialised conv: forward(x)."""

    def __init__(self, in_channels: int, features: int, **kw):
        super().__init__(in_channels, features, **kw)
        self.conv_offset = self._offset_conv(
            self.deformable_groups * self.kernel * self.kernel * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D401
        return self._conv(x, self.conv_offset(x))


class ModulatedDeformConv(DeformConv):
    """DCN v2: forward(x, offset, mask)."""

    def forward(self, x: torch.Tensor, offset: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        return self._conv(x, offset, mask)


class ModulatedDeformConvPack(DeformConv):
    """DCN v2 with offsets and mask from one zero-initialised conv: the
    (dy, dx) pairs first, then the mask channels through a sigmoid."""

    def __init__(self, in_channels: int, features: int, **kw):
        super().__init__(in_channels, features, **kw)
        self.conv_offset_mask = self._offset_conv(
            3 * self.deformable_groups * self.kernel * self.kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.deformable_groups * self.kernel * self.kernel
        om = self.conv_offset_mask(x)
        return self._conv(x, om[:, :2 * n], torch.sigmoid(om[:, 2 * n:]))


class DeformRoIPooling(nn.Module):
    """Deformable PS-RoI pooling: forward(data, rois, trans=None)."""

    def __init__(self, spatial_scale: float, pooled_size: int, output_dim: int,
                 no_trans: bool = False, group_size: int = 1,
                 part_size: Optional[int] = None, sample_per_part: int = 4,
                 trans_std: float = 0.0):
        super().__init__()
        self.spatial_scale, self.pooled_size = spatial_scale, pooled_size
        self.output_dim, self.no_trans = output_dim, no_trans
        self.group_size, self.part_size = group_size, part_size
        self.sample_per_part, self.trans_std = sample_per_part, trans_std

    def forward(self, data: torch.Tensor, rois: torch.Tensor,
                trans: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.no_trans:
            trans = None
        return deform_psroi_pooling(
            data, rois, trans, spatial_scale=self.spatial_scale,
            output_dim=self.output_dim, group_size=self.group_size,
            pooled_size=self.pooled_size, part_size=self.part_size,
            sample_per_part=self.sample_per_part,
            trans_std=self.trans_std if trans is not None else 0.0)


class DeformRoIPoolingPack(DeformRoIPooling):
    """Two-stage deformable RoI pooling: a no-trans pooling feeds a 3-layer
    MLP (zero-initialised last layer) that gives per-bin (dy, dx) offsets
    and a sigmoid mask. forward(data, rois). ``fc0`` reads the pooled map
    flattened as (output_dim, ps, ps), torch's order (the JAX package
    flattens (ps, ps, output_dim); the weight bridge permutes its rows)."""

    def __init__(self, spatial_scale: float, pooled_size: int, output_dim: int,
                 no_trans: bool = False, group_size: int = 1,
                 part_size: Optional[int] = None, sample_per_part: int = 4,
                 trans_std: float = 0.0, deform_fc_dim: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__(spatial_scale, pooled_size, output_dim, no_trans,
                         group_size, part_size, sample_per_part, trans_std)
        gen = generator or torch.Generator().manual_seed(0)
        n_in = pooled_size * pooled_size * output_dim
        self.fc0 = nn.Linear(n_in, deform_fc_dim)
        self.fc1 = nn.Linear(deform_fc_dim, deform_fc_dim)
        self.fc_offset = nn.Linear(deform_fc_dim, 3 * pooled_size * pooled_size)
        for fc, fan_in in ((self.fc0, n_in), (self.fc1, deform_fc_dim)):
            _uniform_(fc.weight, fan_in, gen)
            nn.init.zeros_(fc.bias)
        nn.init.zeros_(self.fc_offset.weight)
        nn.init.zeros_(self.fc_offset.bias)

    def forward(self, data: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        ps = self.pooled_size
        roi = super().forward(data, rois)           # (N, output_dim, ps, ps)
        if self.no_trans:
            return roi
        n = rois.shape[0]
        h = F.relu(self.fc0(roi.reshape(n, -1)))
        h = F.relu(self.fc1(h))
        om = self.fc_offset(h).view(n, 3, ps, ps)
        out = super().forward(data, rois, om[:, :2])
        return out * torch.sigmoid(om[:, 2:3])
