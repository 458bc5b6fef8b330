"""Kernel K3: the encode_dep front, relu(conv1(relu(conv0(x)))).

Replaces the TPU kernel ``dep_encode_front._fwd_kernel``
(``nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py``). CUDA source:
``csrc/dep_encode_front.cu``, whose header says what bounds it on the card
(the FP32 cores: 0.38 GFLOP at NYU size) and how conv0's output stays in
shared memory. Unlike the TPU kernel it takes any H and W.

On a CPU tensor ``dep_encode_front`` runs ``dep_encode_front_plain``; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dep_encode_front_f32": [_P] * 6 + [_I] * 4 + [_P]}
MID_CHANNELS = 16          # conv0's output width, fixed by the model


def _half(n: int) -> int:
    """Output size of a k3/s2/p1 conv."""
    return (n + 1) // 2


def dep_encode_front_plain(xplane: torch.Tensor, w0: torch.Tensor,
                           b0: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor) -> torch.Tensor:
    """Two ``conv2d`` (k3/s2/p1), each followed by a ReLU; NHWC out."""
    y1 = F.relu(F.conv2d(xplane[:, None], w0, b0, 2, 1))
    return F.relu(F.conv2d(y1, w1, b1, 2, 1)).permute(0, 2, 3, 1).contiguous()


def dep_encode_front(xplane: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """xplane: (B, H, W); w0: (16, 1, 3, 3), b0: (16,); w1: (C1, 16, 3, 3),
    b1: (C1,) in torch Conv2d layout. Returns NHWC
    (B, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), C1) f32."""
    if xplane.device.type == "cpu":
        return dep_encode_front_plain(xplane, w0, b0, w1, b1)
    bsz, h, w = xplane.shape
    c1 = w1.shape[0]
    dev = xplane.device
    build.check_tensor(xplane, "dep_encode_front x")
    build.check_tensor(w0, "dep_encode_front w0", (MID_CHANNELS, 1, 3, 3), dev)
    build.check_tensor(b0, "dep_encode_front b0", (MID_CHANNELS,), dev)
    build.check_tensor(w1, "dep_encode_front w1", (c1, MID_CHANNELS, 3, 3), dev)
    build.check_tensor(b1, "dep_encode_front b1", (c1,), dev)
    out = torch.empty((bsz, _half(_half(h)), _half(_half(w)), c1), device=dev,
                      dtype=torch.float32)
    with torch.cuda.device(dev):
        lib = build.load("dep_encode_front", _SIGNATURES)
        err = lib.dep_encode_front_f32(
            xplane.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), out.data_ptr(), bsz, h, w, c1,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "dep_encode_front")
    dep_encode_front.launches += 1
    return out


dep_encode_front.launches = 0
