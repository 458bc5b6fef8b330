"""Planar channel MLP: the S2D pair of 1x1 convs, forward only.

Counterpart of ``nlspn_eccv20_tpu/ops/planar.py``. The JAX package writes the
1x1 convs as scalar-weighted plane sums to dodge the TPU's 128-lane padding
of small-channel NHWC tensors; on the card a 1x1 ``F.conv2d`` over NCHW
planes is the same math in one call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def planar_channel_mlp(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """relu(W1^T relu(W0^T x + b0) + b1) over planar channels.

    x: (B, K0, H, W); w0: (K0, C0); w1: (C0, C1) (the JAX package's
    (in, out) layout). Returns (B, C1, H, W).
    """
    h = F.relu(F.conv2d(x, w0.t()[:, :, None, None], b0))
    return F.relu(F.conv2d(h, w1.t()[:, :, None, None], b1))
