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

On a bf16 plane (``precision='bf16'``) it runs K3-bf16,
``dep_encode_front_bf16`` (CUDA source ``csrc/dep_encode_front_bf16.cu``):
conv0 in f32 FMAs and conv1 on the bf16 tensor cores, summing in f32 and
rounding conv0's output and the output to bf16 where the TPU kernel does
(the f32 weights and biases rounded to bf16); the output is NHWC bf16,
which ``encode_dep``'s stock conv2 reads as it is. Its plain version is
``dep_encode_front_plain_bf16``; ``front_plan_bf16`` mirrors its launch
plan and ``dep_encode_front_bf16_tiles`` its arithmetic, for the CPU tests.
Under autograd a bf16 plane runs ``DepEncodeFrontFunction`` too: K3-bf16 forward, and K5-bf16,
``dep_encode_front_bwd_bf16`` (the TPU backward at ``dt = bfloat16``; the
same CUDA source as K5, its dP0 pass on the bf16 tensor cores), backward,
whose plain version is ``dep_encode_front_bwd_plain_bf16``: it rounds the
weights, conv0's output, dP0 and the plane's gradient to bf16 where
``_bwd_kernel`` does, and returns a bf16 plane gradient (rounded once, as
the JAX model's cast back to the bf16 plane leaves it) and f32 weight
gradients. ``front_bwd_plan_bf16`` mirrors K5-bf16's dP0 launch plan and
``dep_encode_front_bwd_bf16_tiles`` its dP0 arithmetic, for the CPU tests.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.ops.kernels import build, quad_mma
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import CARD_SMS, wgrad_s2_slices

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dep_encode_front_f32": [_P] * 6 + [_I] * 4 + [_P]}
_BF16_SIGNATURES = {
    "dep_encode_front_bf16": [_P] * 7 + [_I] * 4 + [_P],
    "dep_encode_front_bf16_plan": [_I] * 5 + [_P],
    "dep_encode_front_bf16_scratch_bytes": ([_I], ctypes.c_longlong),
}
_BWD_SIGNATURES = {
    "dep_encode_front_bwd_f32": [_P] * 10 + [_I] * 4 + [_P],
    "dep_encode_front_bwd_bf16": [_P] * 10 + [_I] * 4 + [_P],
    "dep_encode_front_bwd_scratch_floats": ([_I] * 4, ctypes.c_longlong),
    "dep_encode_front_bwd_bf16_scratch_floats": ([_I] * 4, ctypes.c_longlong),
    "dep_encode_front_bwd_bf16_plan": [_I] * 4 + [_P],
}
MID_CHANNELS = 16          # conv0's output width, fixed by the model
# K3-bf16 (csrc/dep_encode_front_bf16.cu): output tiles, rows x cols; threads
# a CTA (two teams of two warpgroups); bytes of a staged p0 and plane tile
FRONT_TILE, FRONT_THREADS = (4, 16), 512
FRONT_P0_BYTES, FRONT_PLANE_BYTES = 9 * 33 * 48, 19 * 68 * 4
# K5-bf16's dP0 pass (dp0_mma_kernel): tiles of the base grid, chunk,
# threads, blocks an SM
DP0_TILE, DP0_CHUNK, DP0_THREADS, DP0_BLOCKS_PER_SM = (8, 16), 32, 256, 2


def _half(n: int) -> int:
    """Output size of a k3/s2/p1 conv."""
    return (n + 1) // 2


def dep_encode_front_plain(xplane: torch.Tensor, w0: torch.Tensor,
                           b0: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor) -> torch.Tensor:
    """Two ``conv2d`` (k3/s2/p1), each followed by a ReLU; NHWC out."""
    y1 = F.relu(F.conv2d(xplane[:, None], w0, b0, 2, 1))
    return F.relu(F.conv2d(y1, w1, b1, 2, 1)).permute(0, 2, 3, 1).contiguous()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, held in f32."""
    return t.to(torch.bfloat16).float()


def dep_encode_front_plain_bf16(xplane: torch.Tensor, w0: torch.Tensor,
                                b0: torch.Tensor, w1: torch.Tensor,
                                b1: torch.Tensor) -> torch.Tensor:
    """K3-bf16's plain version: the plane, the weights and the biases
    rounded to bf16, each conv summed in f32 with its bias added in f32,
    conv0's output rounded to bf16 after its ReLU and the output rounded
    to bf16, as the TPU kernel (``_fwd_kernel``) rounds them. NHWC bf16."""
    p0 = _bf16(F.relu(F.conv2d(_bf16(xplane)[:, None], _bf16(w0), _bf16(b0), 2, 1)))
    out = F.relu(F.conv2d(p0, _bf16(w1), _bf16(b1), 2, 1))
    return out.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


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


def dep_encode_front_bwd_plain_bf16(g, xplane, w0, b0, w1, out):
    """K5-bf16's plain version, on its inputs (the plane, g and out bf16):
    ``dep_encode_front_bwd_plain`` rounding where the TPU kernel
    (``_bwd_kernel`` at ``dt = bfloat16``) rounds: the weights and b0 to
    bf16, conv0's output recomputed from them in f32 (its ReLU mask taken
    there) and rounded to bf16, g to bf16 (it arrives bf16), dP0 to bf16
    after its f32 sum and mask, the plane's gradient to bf16 once after its
    f32 sum (returned bf16). The weight and bias gradients are f32 sums of
    the rounded operands. The mask [out > 0] is taken on K3-bf16's rounded
    output, where the TPU kernel takes it before rounding: the two differ
    only where 0 < out <= 2^-134 (``csrc/dec_aff_tail_bwd.cu`` bounds that
    case)."""
    x4 = xplane.float()[:, None]
    w0r, w1r = _bf16(w0), _bf16(w1)
    pf = F.relu(F.conv2d(x4, w0r, _bf16(b0), 2, 1))
    p0 = _bf16(pf)
    gm = (_bf16(g) * (out > 0)).permute(0, 3, 1, 2)
    _, vjp1 = torch.func.vjp(_conv, p0, w1r)
    d_p0, dw1 = vjp1(gm)
    d_p0 = _bf16(d_p0 * (pf > 0))
    _, vjp0 = torch.func.vjp(_conv, x4, w0r)
    dx, dw0 = vjp0(d_p0)
    return (dx[:, 0].to(torch.bfloat16), dw0, d_p0.sum((0, 2, 3)), dw1,
            gm.sum((0, 2, 3)))


def front_plan_bf16(b: int, h: int, w: int, c1: int, sms: int = CARD_SMS) -> Dict[str, int]:
    """K3-bf16's launch as ``plan`` in its source makes it: 4x16 output
    tiles; ``nw`` columns a warpgroup, the least of 16, 32, 64, 128 that
    covers half of C1, and ``passes`` of 2 nw channels; ``grid_x``
    persistent CTAs a pass (one an SM, fewer where the tiles are fewer),
    each of two teams; ``smem`` bytes (a pass's nine taps of B, each team's
    p0 and plane tiles and its staging tile of 64 pixels x 2 nw channels
    and a 16-byte pad, the biases and conv0's weights)."""
    ho, wo = _half(_half(h)), _half(_half(w))
    rows, cols = -(-ho // FRONT_TILE[0]), -(-wo // FRONT_TILE[1])
    nw = 16
    while nw < 128 and 2 * nw < c1:
        nw *= 2
    passes = -(-c1 // (2 * nw))
    team = FRONT_P0_BYTES + FRONT_PLANE_BYTES + 64 * (4 * nw + 16)
    smem = 9 * MID_CHANNELS * 2 * nw * 2 + 2 * team + 2 * nw * 4 + 10 * MID_CHANNELS * 4
    return {"tiles_y": rows, "tiles_x": cols, "nw": nw, "passes": passes,
            "grid_x": min(b * rows * cols, max(1, sms // passes)),
            "threads": FRONT_THREADS, "smem": smem}


def front_plan_bf16_card(b: int, h: int, w: int, c1: int, sms: int) -> Dict[str, int]:
    """The same plan as the built kernel reports it
    (``dep_encode_front_bf16_plan``), for ``chip_smoke.py`` to hold against
    ``front_plan_bf16``."""
    lib = build.load("dep_encode_front_bf16", _BF16_SIGNATURES)
    out = (ctypes.c_int * 7)()
    build.check_launch(lib.dep_encode_front_bf16_plan(b, h, w, c1, sms, out),
                       "dep_encode_front_bf16_plan")
    return dict(zip(("tiles_y", "tiles_x", "nw", "passes", "grid_x", "threads", "smem"), out))


def front_pack_w1(w1: torch.Tensor, nw: int, passes: int) -> torch.Tensor:
    """(passes, 9, 32 nw) bf16: w1 (C1, 16, 3, 3) as ``prep_front_w1_kernel``
    lays it out, each pass's tap the K-major B of 2 nw columns (channel n of
    the pass, conv0 channel k at ``quad_mma.kmajor_index``), zero past C1."""
    c1 = w1.shape[0]
    wpad = torch.zeros(passes * 2 * nw, MID_CHANNELS, 9)
    wpad[:c1] = w1.detach().float().cpu().reshape(c1, MID_CHANNELS, 9)
    n, k = torch.arange(2 * nw), torch.arange(MID_CHANNELS)
    idx = quad_mma.kmajor_index(n[:, None], k[None, :]).reshape(-1)
    out = torch.zeros(passes, 9, 32 * nw, dtype=torch.bfloat16)
    for p in range(passes):
        for tap in range(9):
            out[p, tap, idx] = wpad[p * 2 * nw:(p + 1) * 2 * nw, :, tap].reshape(-1).to(
                torch.bfloat16)
    return out


def front_b_operand(wk: torch.Tensor, n0: int, n: int) -> torch.Tensor:
    """(16, n) f32: the B operand a warpgroup's descriptor reads from a
    tap's packed ``wk``, columns n0 .. n0 + n."""
    cols, k = torch.arange(n0, n0 + n), torch.arange(MID_CHANNELS)
    return wk[quad_mma.kmajor_index(cols[None, :], k[:, None])].float()


def dep_encode_front_bf16_tiles(xplane, w0, b0, w1, b1):
    """K3-bf16 on the CPU as the kernel computes it, tile by tile: p0 from
    the rounded plane and weights, the bias then taps 0-8 added in f32 (each
    product of two bf16 values is exact, so this is the kernel's FMA chain),
    ReLU, bf16, zero past the H1 x W1 grid (conv1's padding); then each 4x16
    output tile of each pass: for each warpgroup's nw columns the nine
    taps' products of the tile's p0 rows with the packed w1
    (``front_pack_w1``) summed in f32, the bias, ReLU and one rounding.
    Returns NHWC bf16."""
    bsz, h, w = xplane.shape
    c1 = w1.shape[0]
    plan = front_plan_bf16(bsz, h, w, c1)
    nw, passes = plan["nw"], plan["passes"]
    th, tw = FRONT_TILE
    ho, wo = _half(_half(h)), _half(_half(w))
    h1, w1_ = _half(h), _half(w)
    x = F.pad(xplane.float(), (1, 1, 1, 1))
    w0r, b0r = _bf16(w0).reshape(MID_CHANNELS, 9), _bf16(b0)
    s = b0r[None, :, None, None].expand(bsz, MID_CHANNELS, h1, w1_).clone()
    for tap in range(9):
        ty, tx = divmod(tap, 3)
        xt = x[:, None, ty:ty + 2 * h1 - 1:2, tx:tx + 2 * w1_ - 1:2]
        s = s + w0r[None, :, tap, None, None] * xt
    p0 = _bf16(F.relu(s))
    # p0 with conv1's padding, and room for the last tiles' positions
    p0p = torch.zeros(bsz, MID_CHANNELS, 2 * th * plan["tiles_y"] + 1,
                      2 * tw * plan["tiles_x"] + 1)
    p0p[:, :, 1:h1 + 1, 1:w1_ + 1] = p0
    wp = front_pack_w1(w1, nw, passes)
    b1r = torch.zeros(passes * 2 * nw)
    b1r[:c1] = _bf16(b1)
    out = torch.zeros(bsz, plan["tiles_y"] * th, plan["tiles_x"] * tw, passes * 2 * nw)
    for b in range(bsz):
        for oy0 in range(0, ho, th):
            for ox0 in range(0, wo, tw):
                # A of tap (ty, tx): M row 16 r + i is output (oy0 + r, ox0 + i)
                a = [p0p[b, :, 2 * oy0 + ty:2 * oy0 + ty + 2 * th:2,
                         2 * ox0 + tx:2 * ox0 + tx + 2 * tw:2].reshape(MID_CHANNELS, -1).t()
                     for ty in range(3) for tx in range(3)]
                for p in range(passes):
                    for wg in range(2):
                        acc = torch.zeros(th * tw, nw)
                        for tap in range(9):
                            acc = acc + a[tap] @ front_b_operand(wp[p, tap], wg * nw, nw)
                        c0 = p * 2 * nw + wg * nw
                        y = _bf16(F.relu(acc + b1r[c0:c0 + nw]))
                        out[b, oy0:oy0 + th, ox0:ox0 + tw, c0:c0 + nw] = y.reshape(th, tw, nw)
    return out[:, :ho, :wo, :c1].to(torch.bfloat16).contiguous()


def front_bwd_plan_bf16(b: int, h: int, w: int, c1: int) -> Dict[str, int]:
    """K5-bf16's dP0 pass as ``layout_bf16`` in its source plans it: 8x16
    tiles of the base grid (the gm grid, ``Ho`` x ``Wo``), the chunks of 32
    channels split over ``split`` blocks a tile so that two blocks an SM
    fill the card, ``smem`` bytes (two chunk buffers of g, out and B, where
    the f32 epilogue tile later lies, then the plane under the tile),
    ``p0_pitch`` p0's row pitch (W1 rounded up to even, for the weight
    gradient's word copies), ``slices`` the weight gradient's."""
    ho, wo = _half(_half(h)), _half(_half(w))
    rows, cols = -(-ho // DP0_TILE[0]), -(-wo // DP0_TILE[1])
    tiles, chunks = b * rows * cols, -(-c1 // DP0_CHUNK)
    g_bytes = (DP0_TILE[0] + 1) * (DP0_TILE[1] + 1) * (DP0_CHUNK + 8) * 2
    stage = 2 * g_bytes + 2 * quad_mma.KSTEP_BF16 * 2
    ep = MID_CHANNELS * 2 * DP0_TILE[0] * (2 * DP0_TILE[1] + 1) * 4
    plane = (4 * DP0_TILE[0] + 1) * (4 * DP0_TILE[1] + 1) * 4
    w1 = _half(w)
    return {"tiles_y": rows, "tiles_x": cols,
            "split": min(-(-DP0_BLOCKS_PER_SM * CARD_SMS // tiles), chunks),
            "threads": DP0_THREADS, "smem": max(2 * stage, ep) + plane, "chunks": chunks,
            "p0_pitch": w1 + w1 % 2, "slices": wgrad_s2_slices(b * ho * wo, c1)}


def front_bwd_plan_bf16_card(b: int, h: int, w: int, c1: int) -> Dict[str, int]:
    """The same plan as the built kernel reports it
    (``dep_encode_front_bwd_bf16_plan``), for ``chip_smoke.py`` to hold
    against ``front_bwd_plan_bf16``."""
    lib = build.load("dep_encode_front_bwd", _BWD_SIGNATURES)
    out = (ctypes.c_int * 8)()
    build.check_launch(lib.dep_encode_front_bwd_bf16_plan(b, h, w, c1, out),
                       "dep_encode_front_bwd_bf16_plan")
    return dict(zip(("tiles_y", "tiles_x", "split", "threads", "smem", "chunks",
                     "p0_pitch", "slices"), out))


def dep_encode_front_bwd_bf16_tiles(g, xplane, w0, b0, w1, out, split: Optional[int] = None):
    """K5-bf16 on the CPU with its dP0 pass as the kernel runs it, tile by
    tile: gm = g [out > 0] staged with the tile's one-pixel halo (zeros past
    the grid), each split's f32 sums over its chunks on the packed w1
    (``quad_mma.pack``, ``quad_mma.mma_kstep``; the 128 M rows are the
    tile's base pixels), the splits added in order, then p0's mask and one
    bf16 rounding; the passes after it as ``dep_encode_front_bwd_plain_bf16``
    computes them. ``split`` defaults to the plan's. Returns what
    ``dep_encode_front_bwd_bf16`` returns; the sums run in another order
    than the tensor cores', as the plain version's do."""
    bsz, h, w = xplane.shape
    c1 = w1.shape[0]
    th, tw = DP0_TILE
    plan = front_bwd_plan_bf16(bsz, h, w, c1)
    n_split = plan["split"] if split is None else split
    chunks = plan["chunks"]
    x4 = xplane.float()[:, None]
    w0r, w1r = _bf16(w0), _bf16(w1)
    pf = F.relu(F.conv2d(x4, w0r, _bf16(b0), 2, 1))
    p0 = _bf16(pf)
    gm_nhwc = _bf16(g) * (out > 0)
    ho, wo = gm_nhwc.shape[1:3]
    h1, w1_ = p0.shape[2:]
    gpad = torch.zeros(bsz, ho + th + 1, wo + tw + 1, chunks * DP0_CHUNK)
    gpad[:, :ho, :wo, :c1] = gm_nhwc.float()
    wp = quad_mma.pack(w1, 2 * chunks)
    rows = [(i, j) for i in range(th) for j in range(tw)]
    sums = torch.zeros(bsz, MID_CHANNELS, 2 * (ho + th), 2 * (wo + tw))
    for b in range(bsz):
        for a0 in range(0, ho, th):
            for t0 in range(0, wo, tw):
                a_rows = [torch.stack([gpad[b, a0 + i + sy, t0 + j + sx] for i, j in rows])
                          for sy, sx in quad_mma.SHIFTS]
                total = None
                for sp in range(n_split):
                    acc = torch.zeros(len(rows), 64)
                    for kc in range(sp * chunks // n_split, (sp + 1) * chunks // n_split):
                        for ks in (2 * kc, 2 * kc + 1):
                            sl = slice(ks * quad_mma.KSTEP, (ks + 1) * quad_mma.KSTEP)
                            quad_mma.mma_kstep(acc, [a[:, sl] for a in a_rows], wp[ks])
                    total = acc if total is None else total + acc
                for q, (dy, dx) in enumerate(quad_mma.PHASES):
                    blk = total[:, 16 * q:16 * q + 16].t().reshape(MID_CHANNELS, th, tw)
                    sums[b, :, 2 * a0 + dy:2 * (a0 + th):2, 2 * t0 + dx:2 * (t0 + tw):2] = blk
    d_p0 = _bf16(sums[:, :, :h1, :w1_] * (pf > 0))
    gm = gm_nhwc.permute(0, 3, 1, 2)
    _, vjp1 = torch.func.vjp(lambda wt: _conv(p0, wt), w1r)
    dw1, = vjp1(gm)
    _, vjp0 = torch.func.vjp(_conv, x4, w0r)
    dx, dw0 = vjp0(d_p0)
    return (dx[:, 0].to(torch.bfloat16), dw0, d_p0.sum((0, 2, 3)), dw1,
            gm.sum((0, 2, 3)))


def _check_inputs(xplane, w0, b0, w1, b1):
    c1 = w1.shape[0]
    dev = xplane.device
    build.check_tensor(xplane, "dep_encode_front x",
                       dtype=torch.bfloat16 if xplane.dtype == torch.bfloat16 else None)
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
    bf16 = xplane.dtype == torch.bfloat16
    out = torch.empty(_out_shape(xplane, c1), device=xplane.device,
                      dtype=xplane.dtype)
    stream = torch.cuda.current_stream(xplane.device).cuda_stream
    with torch.cuda.device(xplane.device):
        if bf16:
            lib = build.load("dep_encode_front_bf16", _BF16_SIGNATURES)
            scratch = torch.empty(lib.dep_encode_front_bf16_scratch_bytes(c1),
                                  device=xplane.device, dtype=torch.uint8)
            err = lib.dep_encode_front_bf16(
                xplane.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), out.data_ptr(), scratch.data_ptr(), bsz, h, w, c1, stream)
        else:
            lib = build.load("dep_encode_front", _SIGNATURES)
            err = lib.dep_encode_front_f32(
                xplane.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), out.data_ptr(), bsz, h, w, c1, stream)
    build.check_launch(err, "dep_encode_front_bf16" if bf16 else "dep_encode_front")
    (dep_encode_front_bf16 if bf16 else dep_encode_front).launches += 1
    return out


def dep_encode_front_bwd(g, xplane, w0, b0, w1, out):
    """K5: (dx, dw0, db0, dw1, db1) at cotangent ``g`` (NHWC, as ``out``),
    from the forward's input and its output ``out``. On a CPU tensor it
    runs ``dep_encode_front_bwd_plain``; on a CUDA tensor it launches the
    kernel or raises. A bf16 plane goes to ``dep_encode_front_bwd_bf16``."""
    if xplane.dtype == torch.bfloat16:
        return dep_encode_front_bwd_bf16(g, xplane, w0, b0, w1, out)
    if xplane.device.type == "cpu":
        return dep_encode_front_bwd_plain(g, xplane, w0, b0, w1, out)
    return _launch_bwd(g, xplane, w0, b0, w1, out)


def dep_encode_front_bwd_bf16(g, xplane, w0, b0, w1, out):
    """K5-bf16: ``dep_encode_front_bwd`` on a bf16 plane, with K3-bf16's
    bf16 output and a bf16 ``g``. Returns the plane's gradient bf16 and the
    weight and bias gradients f32. On a CPU tensor it runs
    ``dep_encode_front_bwd_plain_bf16``; on a CUDA tensor it launches the
    kernel or raises."""
    if xplane.device.type == "cpu":
        return dep_encode_front_bwd_plain_bf16(g, xplane, w0, b0, w1, out)
    if xplane.dtype != torch.bfloat16:
        raise ValueError(
            f"dep_encode_front_bwd_bf16 x: expected bfloat16, got {xplane.dtype}")
    return _launch_bwd(g, xplane, w0, b0, w1, out)


def _launch_bwd(g, xplane, w0, b0, w1, out):
    bsz, h, w = xplane.shape
    c1 = w1.shape[0]
    dev = xplane.device
    _check_inputs(xplane, w0, b0, w1, None)
    shape = _out_shape(xplane, c1)
    bf16 = xplane.dtype == torch.bfloat16
    dtype = xplane.dtype if bf16 else None
    build.check_tensor(g, "dep_encode_front_bwd g", shape, dev, dtype)
    build.check_tensor(out, "dep_encode_front_bwd out", shape, dev, dtype)
    m = MID_CHANNELS
    dx = torch.empty_like(xplane)
    dw0b = torch.empty(m * 9 + m, device=dev, dtype=torch.float32)
    dw1b = torch.empty(c1 * m * 9 + c1, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        lib = build.load("dep_encode_front_bwd", _BWD_SIGNATURES)
        floats = (lib.dep_encode_front_bwd_bf16_scratch_floats if bf16
                  else lib.dep_encode_front_bwd_scratch_floats)
        scratch = torch.empty(floats(bsz, h, w, c1), device=dev, dtype=torch.float32)
        err = (lib.dep_encode_front_bwd_bf16 if bf16 else lib.dep_encode_front_bwd_f32)(
            xplane.data_ptr(), g.data_ptr(), out.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), w1.data_ptr(), dx.data_ptr(), dw0b.data_ptr(),
            dw1b.data_ptr(), scratch.data_ptr(), bsz, h, w, c1,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "dep_encode_front_bwd")
    (dep_encode_front_bwd_bf16 if bf16 else dep_encode_front_bwd).launches += 1
    return (dx, dw0b[:m * 9].view(m, 1, 3, 3), dw0b[m * 9:],
            dw1b[:c1 * m * 9].view(c1, m, 3, 3), dw1b[c1 * m * 9:])


class DepEncodeFrontFunction(torch.autograd.Function):
    """K3 forward, K5 backward (their plain versions on CPU tensors); on a
    bf16 plane K3-bf16 and K5-bf16."""

    @staticmethod
    def forward(ctx, xplane, w0, b0, w1, b1):
        if xplane.device.type != "cpu":
            fwd = _launch_fwd
        elif xplane.dtype == torch.bfloat16:
            fwd = dep_encode_front_plain_bf16
        else:
            fwd = dep_encode_front_plain
        out = fwd(xplane, w0, b0, w1, b1)
        ctx.save_for_backward(xplane, w0, b0, w1, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return dep_encode_front_bwd(g.contiguous(), *ctx.saved_tensors)


def dep_encode_front(xplane: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """xplane: (B, H, W) f32 or bf16; w0: (16, 1, 3, 3), b0: (16,);
    w1: (C1, 16, 3, 3), b1: (C1,) f32 in torch Conv2d layout. Returns NHWC
    (B, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), C1) in the plane's dtype. A
    bf16 plane goes to ``dep_encode_front_bf16``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xplane, w0, b0, w1, b1)):
        return DepEncodeFrontFunction.apply(xplane, w0, b0, w1, b1)
    if xplane.dtype == torch.bfloat16:
        return dep_encode_front_bf16(xplane, w0, b0, w1, b1)
    if xplane.device.type == "cpu":
        return dep_encode_front_plain(xplane, w0, b0, w1, b1)
    return _launch_fwd(xplane, w0, b0, w1, b1)


def dep_encode_front_bf16(xplane: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                          w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """K3-bf16: ``dep_encode_front`` on a bf16 plane, the weights and biases
    f32 (the kernel rounds them to bf16). Returns NHWC bf16. On a CPU
    tensor it runs ``dep_encode_front_plain_bf16``; on a CUDA tensor it
    launches the kernel or raises. Under autograd it runs
    ``DepEncodeFrontFunction``, whose backward is K5-bf16."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xplane, w0, b0, w1, b1)):
        return DepEncodeFrontFunction.apply(xplane, w0, b0, w1, b1)
    if xplane.device.type == "cpu":
        return dep_encode_front_plain_bf16(xplane, w0, b0, w1, b1)
    if xplane.dtype != torch.bfloat16:
        raise ValueError(f"dep_encode_front_bf16 x: expected bfloat16, got {xplane.dtype}")
    return _launch_fwd(xplane, w0, b0, w1, b1)


dep_encode_front.launches = 0
dep_encode_front_bf16.launches = 0
dep_encode_front_bwd.launches = 0
dep_encode_front_bwd_bf16.launches = 0


def dep_encode_front_case(gen: torch.Generator, device, b: int, h: int, w: int,
                          c: int = 256):
    """Inputs on which K3 is checked and timed on the card, from ``gen``: an
    h x w plane in [0, 1) and C1 = c. Returns (args of ``dep_encode_front``
    and its plain version, library): ``library`` is the two cuDNN convs
    with their ReLUs, NCHW out."""
    def randn(*shape, std):
        return (torch.randn(shape, generator=gen) * std).to(device)
    plane = torch.rand((b, h, w), generator=gen).to(device)
    w0, b0 = randn(MID_CHANNELS, 1, 3, 3, std=1 / 3), randn(MID_CHANNELS, std=0.1)
    w1, b1 = randn(c, MID_CHANNELS, 3, 3, std=1 / 12), randn(c, std=0.1)
    p4 = plane[:, None]

    def library():
        return F.relu(F.conv2d(F.relu(F.conv2d(p4, w0, b0, 2, 1)), w1, b1, 2, 1))

    return (plane, w0, b0, w1, b1), library


def dep_encode_front_bwd_case(gen: torch.Generator, device, b: int, h: int,
                              w: int, c: int = 256,
                              dtype: torch.dtype = torch.float32):
    """Inputs on which K5 (K5-bf16 with ``dtype=torch.bfloat16``: the plane,
    g and out bf16) is checked and timed on the card, from ``gen``: an
    h x w plane and C1 = c. The plane and conv0's weights are multiples of
    1/64 (bf16 values too), so that conv0's sums are exact in any order: K5
    recomputes conv0 as K3 does, its plain version through cuDNN, and both
    then take the same ReLU mask. Returns (args of ``dep_encode_front_bwd``
    and its plain version, library), as ``decode_aff_tail_bwd_case``."""
    def sixty_fourths(*shape, lo, hi):
        return (torch.randint(lo, hi + 1, shape, generator=gen) / 64).to(device)
    m = MID_CHANNELS
    plane = sixty_fourths(b, h, w, lo=0, hi=64)
    w0, b0 = sixty_fourths(m, 1, 3, 3, lo=-21, hi=21), sixty_fourths(m, lo=-6, hi=6)
    w1 = (torch.randn((c, m, 3, 3), generator=gen) / 12).to(device)
    b1 = (torch.randn((c,), generator=gen) * 0.1).to(device)
    plane = plane.to(dtype)
    out = dep_encode_front(plane, w0, b0, w1, b1)
    g = torch.randn(out.shape, generator=gen).to(device).to(dtype)
    p4 = plane[:, None]
    w0n, b0n, w1n = (t.to(dtype) for t in (w0, b0, w1))
    p0 = F.relu(F.conv2d(p4, w0n, b0n, 2, 1))
    out_n = out.permute(0, 3, 1, 2).contiguous()
    g_n = g.permute(0, 3, 1, 2).contiguous()
    conv_bwd = torch.ops.aten.convolution_backward

    def library():
        gm = torch.ops.aten.threshold_backward(g_n, out_n, 0.0)
        d_p0, d_w1, d_b1 = conv_bwd(gm, p0, w1n, [c], [2, 2], [1, 1], [1, 1],
                                    False, [0, 0], 1, [True, True, True])
        d_p0 = torch.ops.aten.threshold_backward(d_p0, p0, 0.0)
        return conv_bwd(d_p0, p4, w0n, [m], [2, 2], [1, 1], [1, 1], False,
                        [0, 0], 1, [True, True, True]) + (d_w1, d_b1)

    return (g, plane, w0, b0, w1, out), library
