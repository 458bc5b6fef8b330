"""Building blocks: Conv / ConvTranspose + BN + ReLU, NCHW.

Counterpart of ``nlspn_eccv20_tpu/models/common.py``. The blocks are
``nn.Sequential``s laid out as the reference ``conv_bn_relu`` /
``convt_bn_relu`` helpers are, so their parameters carry the reference
``state_dict`` names (``<name>.0.weight`` for the conv, ``<name>.1.*`` for
the BatchNorm). Well-shaped convolutions stay ``F.conv2d`` /
``F.conv_transpose2d`` (cuDNN on the card), as the JAX package leaves them
to XLA. ``ConvTranspose`` keeps torch's own (un-flipped) weight layout
``(in, out, k, k)``; the weight bridge un-flips the JAX package's
pre-flipped storage.

``BatchNorm`` normalises with its running statistics in eval mode and with
the batch's in train mode, eps 1e-5 and momentum 0.1 as in the JAX package;
in train mode it updates the running variance with the batch's biased
variance, as Flax does.

Mixed precision (``precision='bf16'``) as the JAX package has it: the
parameters stay f32, and each block computes in its input's dtype. ``Conv``
and ``ConvTranspose`` cast their weight and bias to that dtype at use (the
library adds the bias before it rounds the output, where the JAX ``Conv``
rounds first and adds in bf16), so their parameters' gradients arrive f32;
``BatchNorm`` normalises in f32 and returns the input's dtype, in both
modes. In train mode on bf16 (Flax's ``BatchNorm(dtype=bf16,
param_dtype=f32)``) the batch statistics are f32 reductions of the bf16
input and the running statistics are updated in f32; the library's fused
batch norm takes the variance in a stable form where Flax takes E[x^2] -
E[x]^2 (clipped at 0), a difference of f32 rounding only
(``tests/test_torch_bf16_train.py`` measures it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _zero_init(conv: nn.Module, zero_init: bool) -> None:
    """Zero the conv, and mark it so for ``utils.weights.init_weights_``."""
    conv.zero_init = zero_init
    if zero_init:
        nn.init.zeros_(conv.weight)
        if conv.bias is not None:
            nn.init.zeros_(conv.bias)


def cast_to(t, dtype):
    """``t`` in ``dtype`` (None stays None): an f32 parameter at its use."""
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype, the parameters cast at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast_to(self.weight, x.dtype),
                                  cast_to(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (fixed output_padding) in its input's dtype,
    the parameters cast at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, cast_to(self.weight, x.dtype),
                                  cast_to(self.bias, x.dtype), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


def Conv(ch_in: int, ch_out: int, kernel: int = 3, stride: int = 1,
         bias: bool = True, zero_init: bool = False) -> nn.Conv2d:
    """Conv2d with the reference's padding (k - 1) // 2 and torch default init."""
    conv = Conv2d(ch_in, ch_out, kernel, stride, (kernel - 1) // 2, bias=bias)
    _zero_init(conv, zero_init)
    return conv


def ConvTranspose(ch_in: int, ch_out: int, bias: bool = True,
                  zero_init: bool = False) -> nn.ConvTranspose2d:
    """ConvTranspose2d(k3, s2, p1, output_padding 1): exactly doubles H and W."""
    conv = ConvTranspose2d(ch_in, ch_out, 3, 2, 1, 1, bias=bias)
    _zero_init(conv, zero_init)
    return conv


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state_dict names) whose train mode updates
    ``running_var`` with the biased batch variance, as Flax's BatchNorm
    does; ``nn.BatchNorm2d`` would use the unbiased one."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x.float()).to(x.dtype)
        # The library's batch norm with f32 parameters reduces the statistics
        # in f32 and normalises in f32, for a bf16 input too, rounding the
        # output once. With momentum 1 it hands back the batch mean and
        # unbiased variance, from which the running statistics take the
        # biased variance in f32.
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class ConvBNReLU(nn.Sequential):
    """Reference ``conv_bn_relu``: [0] conv (bias iff no BN), [1] BN, ReLU."""

    def __init__(self, ch_in: int, ch_out: int, kernel: int = 3,
                 stride: int = 1, bn: bool = True, relu: bool = True,
                 zero_init: bool = False):
        layers = [Conv(ch_in, ch_out, kernel, stride, bias=not bn,
                       zero_init=zero_init)]
        if bn:
            layers.append(BatchNorm(ch_out))
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class ConvTBNReLU(nn.Sequential):
    """Reference ``convt_bn_relu`` with k3/s2/p1/op1 geometry."""

    def __init__(self, ch_in: int, ch_out: int, bn: bool = True,
                 relu: bool = True, zero_init: bool = False):
        layers = [ConvTranspose(ch_in, ch_out, bias=not bn,
                                zero_init=zero_init)]
        if bn:
            layers.append(BatchNorm(ch_out))
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


def concat_trim(fd: torch.Tensor, fe: torch.Tensor) -> torch.Tensor:
    """Trim the decoder feature's bottom/right over-padding to the encoder
    skip's size, then concatenate along channels (reference ``_concat``)."""
    return torch.cat([clip_to(fd, fe.shape[2], fe.shape[3]), fe], dim=1)


def clip_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Trim bottom/right padding of an NCHW tensor to (h, w)."""
    return x[:, :, :h, :w]
