"""The yardstick of the device metrics: the card's peaks and the least
time each of the port's kernels could take.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
its full 700 W: float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35
TB/s; the PCIe part's beside them. A kernel's bound is the larger of its
operations over the float32 peak and its bytes over the HBM peak, where
the bytes count each input read once and each output written once and
the operations are those its function needs, both from the shapes alone.

``ops_of_step`` lists, for a configuration and the shapes of one step or
request, every call of the port's kernels as (op, calls, flops, bytes):
K1/K1b (``prop_step``), K7/K8 (``deform_prop``), K2/K4
(``dec_aff_tail``), K3/K5 (``dep_encode_front``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAKS = {"SXM": {"f32_tflops": 67.0, "bf16_tflops": 989.0, "tf32_tflops": 494.7,
                 "hbm_tbps": 3.35},
         "PCIe": {"f32_tflops": 51.0, "bf16_tflops": 756.0, "tf32_tflops": 378.0,
                  "hbm_tbps": 2.0}}
F32 = 4


def part(device_name: str) -> str:
    return "PCIe" if "PCIe" in device_name else "SXM"


def bound_s(flops: float, nbytes: float, peak: Dict[str, float]) -> float:
    """The least time in seconds: operations at the float32 peak or bytes at
    the HBM peak, whichever takes longer."""
    return max(flops / (peak["f32_tflops"] * 1e12), nbytes / (peak["hbm_tbps"] * 1e12))


def taps_t2(n: int) -> int:
    """(output, tap) pairs along one axis of a k3/s2/p1/op1 transposed conv
    over n inputs."""
    return 3 * n - 1


def taps_s2(n: int) -> int:
    """(output, tap) pairs along one axis of a k3/s2/p1 conv over n inputs."""
    return 3 * ((n + 1) // 2) - 1 - (n % 2)


def half(n: int) -> int:
    return (n + 1) // 2


def prop_step(b, h, w, k2) -> Tuple[float, float]:
    """K1: per pixel 2 a tap, the blend's 4, conf's 1; pred, conf, dep, the
    K2 affinities in, the plane out."""
    return b * h * w * (2 * k2 + 5), F32 * b * h * w * (k2 + 4)


def prop_step_bwd(b, h, w, k2) -> Tuple[float, float]:
    """K1b: per pixel d_aff 1 a tap, d_p 2 a tap and 4 more; g, pred, aff,
    conf, dep in, d_pred, d_aff, d_conf out."""
    return b * h * w * (3 * k2 + 4), F32 * b * h * w * (2 * k2 + 6)


def deform_prop(b, h, w, k2) -> Tuple[float, float]:
    """K7: per neighbour 4 taps of (conf, weight, product, sum), 8 for the
    fractions and weights and 2 for the affinity; the blend's 5; pred, the
    2 K2 offsets, K2 affinities, conf, dep in, the plane out."""
    return b * h * w * (26 * k2 + 5), F32 * b * h * w * (3 * k2 + 4)


def deform_prop_bwd(b, h, w, k2) -> Tuple[float, float]:
    """K8: per neighbour up to 3x3 taps of value and two slopes and the four
    corners' scatter; g, pred, offsets, aff, conf, dep in, their four
    gradients out."""
    return b * h * w * (60 * k2 + 10), F32 * b * h * w * (6 * k2 + 6)


def dec_aff_tail(b, hg, wg, c, k) -> Tuple[float, float]:
    """K2: deconv1 (c -> 16) and deconv2 (16 -> k), k3/s2/p1/op1, over the
    base grid hg x wg; x, both weights and biases in, the 4hg x 4wg planes
    out."""
    flops = 2 * b * (taps_t2(hg) * taps_t2(wg) * c * 16
                     + taps_t2(2 * hg) * taps_t2(2 * wg) * 16 * k)
    nbytes = F32 * (b * hg * wg * c + c * 16 * 9 + 16 + 16 * k * 9 + k
                    + b * k * 16 * hg * wg)
    return flops, nbytes


def dec_aff_tail_bwd(b, hg, wg, c, k) -> Tuple[float, float]:
    """K4: the forward's products twice (dx and the weight gradients); g,
    x, both weights and y1 in, dx and the four weight and bias gradients
    out."""
    f, _ = dec_aff_tail(b, hg, wg, c, k)
    nbytes = F32 * (b * k * 16 * hg * wg + 2 * b * hg * wg * c
                    + 2 * (c * 16 * 9 + 16 * k * 9) + b * 16 * 4 * hg * wg + 16 + k)
    return 2 * f, nbytes


def dep_encode_front(b, h, w, c) -> Tuple[float, float]:
    """K3: conv0 (1 -> 16) and conv1 (16 -> c), k3/s2/p1, on an h x w plane;
    the plane, weights and biases in, the NHWC output out."""
    h4, w4 = half(half(h)), half(half(w))
    flops = 2 * b * (taps_s2(h) * taps_s2(w) * 16
                     + taps_s2(half(h)) * taps_s2(half(w)) * 16 * c)
    nbytes = F32 * (b * h * w + 16 * 9 + 16 + c * 16 * 9 + c + b * h4 * w4 * c)
    return flops, nbytes


def dep_encode_front_bwd(b, h, w, c) -> Tuple[float, float]:
    """K5: dx, dW0 and the recomputed conv0, dP0 and dW1; g, the plane, the
    weights and the forward's output in, dx and the weight and bias
    gradients out."""
    h4, w4 = half(half(h)), half(half(w))
    conv0 = taps_s2(h) * taps_s2(w) * 16
    conv1 = taps_s2(half(h)) * taps_s2(half(w)) * 16 * c
    nbytes = F32 * (2 * b * h4 * w4 * c + 2 * b * h * w + 2 * (16 * 9 + c * 16 * 9)
                    + 16 + 16 + c)
    return 2 * b * (3 * conv0 + 2 * conv1), nbytes


def ops_of_step(cfg: Dict, b: int, h: int, w: int,
                train: bool) -> List[Tuple[str, int, float, float]]:
    """Every call of the port's kernels in one step (``train``) or one
    forward of the model on a batch b x h x w, as (op, calls, flops, bytes)
    a call."""
    k2 = cfg["prop_kernel"] ** 2
    t = cfg["prop_time"]
    ops = []
    if cfg["offset"]:
        ops.append(("deform_prop", t) + deform_prop(b, h, w, k2))
        if train:
            ops.append(("deform_prop_bwd", t) + deform_prop_bwd(b, h, w, k2))
    else:
        ops.append(("prop_step", t) + prop_step(b, h, w, k2))
        if train:
            ops.append(("prop_step_bwd", t) + prop_step_bwd(b, h, w, k2))
    if cfg["use_GRU"] and t > 1:
        hg, wg = 2 * half(half(half(h))), 2 * half(half(half(w)))
        c, k = 2 * cfg["GRU_hidden_dim"], k2 - 1
        ci = 2 * cfg["GRU_input_dim"]
        ops.append(("dec_aff_tail", t - 1) + dec_aff_tail(b, hg, wg, c, k))
        ops.append(("dep_encode_front", t - 1) + dep_encode_front(b, h, w, ci))
        if train:
            ops.append(("dec_aff_tail_bwd", t - 1) + dec_aff_tail_bwd(b, hg, wg, c, k))
            ops.append(("dep_encode_front_bwd", t - 1) + dep_encode_front_bwd(b, h, w, ci))
    return ops
