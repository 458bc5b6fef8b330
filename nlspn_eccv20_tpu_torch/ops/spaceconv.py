"""Space-to-depth forms of stride-2 convolutions, NCHW (op library).

Counterpart of ``nlspn_eccv20_tpu/ops/spaceconv.py``, the same exact
regrouping of the multiplies and adds:

* a stride-2 3x3 conv (padding 1) is a dense 2x2 conv over the 4-phase
  space-to-depth input (channels x4), padded by one row and column at the
  top and left;
* a stride-2 3x3 transposed conv (padding 1, output_padding 1) is a dense
  2x2 conv to 4-phase outputs (channels x4), padded at the bottom and
  right, followed by depth-to-space;
* a stride-2 1x1 conv is a 1x1 conv of the even-phase slice.

Channels of the phase form are phase-major, ``(a * 2 + b) * C + c`` for
pixel parity (a, b), as in the JAX package. Weights are torch's: a
``Conv2d`` weight (Co, Ci, k, k), a ``ConvTranspose2d`` weight
(Ci, Co, 3, 3) (the JAX function takes its pre-flipped HWIO kernel
instead). Plain PyTorch: the JAX module is plain XLA. Neither model routes
through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (dense tap, phase, kernel index) per spatial dimension
_CONV_TAPS = ((0, 1, 0), (1, 0, 1), (1, 1, 2))
# the same for the transposed conv, kernel index into the flipped kernel
_CONVT_TAPS = ((0, 0, 1), (0, 1, 0), (1, 1, 2))


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 2U, 2V) -> (B, 4C, U, V), channel (a * 2 + b) * C + c."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, 4 * c, h // 2, w // 2)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """(B, 4C, U, V) -> (B, C, 2U, 2V), the inverse of ``space_to_depth``."""
    n, c4, u, v = y.shape
    c = c4 // 4
    y = y.reshape(n, 2, 2, c, u, v).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c, 2 * u, 2 * v)


def _conv_s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """Conv2d weight (Co, Ci, 3, 3), stride 2 -> dense (Co, 4 Ci, 2, 2)."""
    co, ci = w.shape[:2]
    w2 = w.new_zeros((co, 4 * ci, 2, 2))
    for th, a, dkh in _CONV_TAPS:
        for tw, b, dkw in _CONV_TAPS:
            ph = a * 2 + b
            w2[:, ph * ci:(ph + 1) * ci, th, tw] = w[:, :, dkh, dkw]
    return w2


def _convt_d2s_weight(w: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d weight (Ci, Co, 3, 3) -> dense (4 Co, Ci, 2, 2)."""
    ci, co = w.shape[:2]
    wf = w.flip(2, 3)
    w2 = w.new_zeros((4 * co, ci, 2, 2))
    for th, a, dkh in _CONVT_TAPS:
        for tw, b, dkw in _CONVT_TAPS:
            ph = a * 2 + b
            w2[ph * co:(ph + 1) * co, :, th, tw] = wf[:, :, dkh, dkw].t()
    return w2


def conv3x3_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv2d(x, w, stride=2, padding=1)`` for even H and W, through
    space-to-depth. x (B, Ci, H, W), w (Co, Ci, 3, 3); (B, Co, H/2, W/2)."""
    xs = F.pad(space_to_depth(x), (1, 0, 1, 0))
    return F.conv2d(xs, _conv_s2d_weight(w))


def convt3x3_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)``
    through depth-to-space. x (B, Ci, H, W), w (Ci, Co, 3, 3);
    (B, Co, 2H, 2W)."""
    y = F.conv2d(F.pad(x, (0, 1, 0, 1)), _convt_d2s_weight(w))
    return depth_to_space(y)


def conv1x1_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 1x1 conv: a 1x1 conv of the even-phase slice. w
    (Co, Ci, 1, 1)."""
    return F.conv2d(x[:, :, ::2, ::2], w)
