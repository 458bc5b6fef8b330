"""Kernel K3: the encode_dep front, relu(conv1(relu(conv0(x)))), and its
backward K5.

K3 replaces the TPU kernel ``dep_encode_front._fwd_kernel``
(``nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py``). CUDA source:
``csrc/dep_encode_front.cu``, whose header says what bounds it on the card
(the FP32 cores: 0.38 GFLOP at NYU size) and how conv0's output stays in
shared memory. Unlike the TPU kernel it takes any H and W. K5 replaces the
TPU backward (``_bwd_kernel``, reached from ``_bwd_pallas``); CUDA source
``csrc/dep_encode_front_bwd.cu``. It reads the forward's output for conv1's
ReLU mask and recomputes conv0's.

``dep_encode_front`` is differentiable: under autograd it runs
``DepEncodeFrontFunction``, whose backward is K5 on a CUDA tensor and
``dep_encode_front_bwd_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dep_encode_front_f32": [_P] * 6 + [_I] * 4 + [_P]}
_BWD_SIGNATURES = {
    "dep_encode_front_bwd_f32": [_P] * 10 + [_I] * 4 + [_P],
    "dep_encode_front_bwd_scratch_floats": ([_I] * 4, ctypes.c_longlong),
}
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


def _conv(x, w):
    return F.conv2d(x, w, None, 2, 1)


def dep_encode_front_bwd_plain(g, xplane, w0, b0, w1, out):
    """K5's plain version, on K5's inputs: (dx, dw0, db0, dw1, db1) at
    cotangent g (NHWC, as ``out``), from the forward's input and its output
    ``out`` (whose ReLU mask it uses, as K5 does); conv0 is recomputed."""
    x4 = xplane[:, None]
    p0 = F.relu(F.conv2d(x4, w0, b0, 2, 1))
    gm = (g * (out > 0)).permute(0, 3, 1, 2)
    _, vjp1 = torch.func.vjp(_conv, p0, w1)
    d_p0, dw1 = vjp1(gm)
    d_p0 = d_p0 * (p0 > 0)
    _, vjp0 = torch.func.vjp(_conv, x4, w0)
    dx, dw0 = vjp0(d_p0)
    return dx[:, 0], dw0, d_p0.sum((0, 2, 3)), dw1, gm.sum((0, 2, 3))


def _check_inputs(xplane, w0, b0, w1, b1):
    c1 = w1.shape[0]
    dev = xplane.device
    build.check_tensor(xplane, "dep_encode_front x")
    build.check_tensor(w0, "dep_encode_front w0", (MID_CHANNELS, 1, 3, 3), dev)
    build.check_tensor(b0, "dep_encode_front b0", (MID_CHANNELS,), dev)
    build.check_tensor(w1, "dep_encode_front w1", (c1, MID_CHANNELS, 3, 3), dev)
    if b1 is not None:
        build.check_tensor(b1, "dep_encode_front b1", (c1,), dev)


def _out_shape(xplane, c1):
    bsz, h, w = xplane.shape
    return (bsz, _half(_half(h)), _half(_half(w)), c1)


def _launch_fwd(xplane, w0, b0, w1, b1):
    bsz, h, w = xplane.shape
    c1 = w1.shape[0]
    _check_inputs(xplane, w0, b0, w1, b1)
    out = torch.empty(_out_shape(xplane, c1), device=xplane.device,
                      dtype=torch.float32)
    with torch.cuda.device(xplane.device):
        lib = build.load("dep_encode_front", _SIGNATURES)
        err = lib.dep_encode_front_f32(
            xplane.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), out.data_ptr(), bsz, h, w, c1,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "dep_encode_front")
    dep_encode_front.launches += 1
    return out


def dep_encode_front_bwd(g, xplane, w0, b0, w1, out):
    """K5: (dx, dw0, db0, dw1, db1) at cotangent ``g`` (NHWC, as ``out``),
    from the forward's input and its output ``out``. On a CPU tensor it
    runs ``dep_encode_front_bwd_plain``; on a CUDA tensor it launches the
    kernel or raises."""
    if xplane.device.type == "cpu":
        return dep_encode_front_bwd_plain(g, xplane, w0, b0, w1, out)
    bsz, h, w = xplane.shape
    c1 = w1.shape[0]
    dev = xplane.device
    _check_inputs(xplane, w0, b0, w1, None)
    shape = _out_shape(xplane, c1)
    build.check_tensor(g, "dep_encode_front_bwd g", shape, dev)
    build.check_tensor(out, "dep_encode_front_bwd out", shape, dev)
    m = MID_CHANNELS
    dx = torch.empty_like(xplane)
    dw0b = torch.empty(m * 9 + m, device=dev, dtype=torch.float32)
    dw1b = torch.empty(c1 * m * 9 + c1, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        lib = build.load("dep_encode_front_bwd", _BWD_SIGNATURES)
        scratch = torch.empty(lib.dep_encode_front_bwd_scratch_floats(bsz, h, w, c1),
                              device=dev, dtype=torch.float32)
        err = lib.dep_encode_front_bwd_f32(
            xplane.data_ptr(), g.data_ptr(), out.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), w1.data_ptr(), dx.data_ptr(), dw0b.data_ptr(),
            dw1b.data_ptr(), scratch.data_ptr(), bsz, h, w, c1,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "dep_encode_front_bwd")
    dep_encode_front_bwd.launches += 1
    return (dx, dw0b[:m * 9].view(m, 1, 3, 3), dw0b[m * 9:],
            dw1b[:c1 * m * 9].view(c1, m, 3, 3), dw1b[c1 * m * 9:])


class DepEncodeFrontFunction(torch.autograd.Function):
    """K3 forward, K5 backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, xplane, w0, b0, w1, b1):
        fwd = dep_encode_front_plain if xplane.device.type == "cpu" else _launch_fwd
        out = fwd(xplane, w0, b0, w1, b1)
        ctx.save_for_backward(xplane, w0, b0, w1, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return dep_encode_front_bwd(g.contiguous(), *ctx.saved_tensors)


def dep_encode_front(xplane: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """xplane: (B, H, W); w0: (16, 1, 3, 3), b0: (16,); w1: (C1, 16, 3, 3),
    b1: (C1,) in torch Conv2d layout. Returns NHWC
    (B, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), C1) f32."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xplane, w0, b0, w1, b1)):
        return DepEncodeFrontFunction.apply(xplane, w0, b0, w1, b1)
    if xplane.device.type == "cpu":
        return dep_encode_front_plain(xplane, w0, b0, w1, b1)
    return _launch_fwd(xplane, w0, b0, w1, b1)


dep_encode_front.launches = 0
dep_encode_front_bwd.launches = 0
