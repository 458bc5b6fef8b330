"""Kernel K2: the decode_aff tail, deconv2(relu(deconv1(x))).

Replaces the TPU kernel ``dec_aff_tail._fwd_kernel``
(``nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py``). CUDA source:
``csrc/dec_aff_tail.cu``, whose header says what bounds it on the card (the
FP32 cores: 0.42 GFLOP at NYU size) and how the 16-channel intermediate
stays in shared memory.

On a CPU tensor ``decode_aff_tail`` runs ``decode_aff_tail_plain``; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dec_aff_tail_f32": [_P] * 6 + [_I] * 5 + [_P]}
MID_CHANNELS = 16          # deconv1's output width, fixed by the model
OUT_CHANNELS = (8, 24)     # prop_kernel 3 and 5


def decode_aff_tail_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Two ``conv_transpose2d`` (k3/s2/p1/op1) with a ReLU between them."""
    y1 = F.relu(F.conv_transpose2d(x.permute(0, 3, 1, 2), w1, b1, 2, 1, 1))
    return F.conv_transpose2d(y1, w2, b2, 2, 1, 1).contiguous()


def decode_aff_tail(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x: (B, Hg, Wg, C) NHWC; w1: (C, 16, 3, 3), b1: (16,); w2: (16, K, 3, 3),
    b2: (K,) in torch ConvTranspose2d layout, K = 8 or 24.
    Returns planar (B, K, 4Hg, 4Wg) f32."""
    if x.device.type == "cpu":
        return decode_aff_tail_plain(x, w1, b1, w2, b2)
    bsz, hg, wg, c = x.shape
    k = w2.shape[1]
    if k not in OUT_CHANNELS:
        raise ValueError(f"decode_aff_tail: K = {k}, the kernel takes {OUT_CHANNELS}")
    dev = x.device
    build.check_tensor(x, "decode_aff_tail x")
    build.check_tensor(w1, "decode_aff_tail w1", (c, MID_CHANNELS, 3, 3), dev)
    build.check_tensor(b1, "decode_aff_tail b1", (MID_CHANNELS,), dev)
    build.check_tensor(w2, "decode_aff_tail w2", (MID_CHANNELS, k, 3, 3), dev)
    build.check_tensor(b2, "decode_aff_tail b2", (k,), dev)
    out = torch.empty((bsz, k, 4 * hg, 4 * wg), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        lib = build.load("dec_aff_tail", _SIGNATURES)
        err = lib.dec_aff_tail_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), bsz, hg, wg, c, k,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "decode_aff_tail")
    decode_aff_tail.launches += 1
    return out


decode_aff_tail.launches = 0
