"""Kernels K11b, K11c and K11d: three ways to assemble the 4x4 phases,
and the microbenchmark that times them.

Counterpart of the JAX package's ``devtools/microbench_asm.py``. Input: 16
phases x 8 channels in the first 58 rows and 76 columns of padded planes,
(B, 128, Hp, Wp) (the TPU's (B, 128, 64, 128)); output (B, 8, 232, 304):

* K11b (``csrc/interleave_strided.cu``) replaces the TPU kernel
  ``k_strided``: the interleave out[n, c, 4i + a, 4j + b] =
  ph[n, (4a + b) * 8 + c, i, j], written input-driven as the TPU's
  strided stores are: a thread owns 4 columns of the four phases b of one
  (n, a, c, i), whose 64 contiguous output bytes its warp stores whole
  (``strided_plan`` and ``strided_map`` mirror its launch and thread map);
* K11c (``csrc/tile_repeat_probe.cu``) replaces ``k_repeat``, a timing
  probe and not an interleave: ``pltpu.repeat`` tiles the plane blockwise,
  so out[n, c, y, x] = ph[n, ((y % 4) * 4 + x % 4) * 8 + c, y % 58, x % 76];
  it is held to that formula only;
* K11d (``csrc/interleave_onehot.cu``) replaces ``k_matmul``, the lane
  expansion by one-hot products: out[n, c, 4i + a, x] =
  sum_b sum_j ph[n, (4a + b) * 8 + c, i, j] * E[b, j, x], a GEMM of depth
  304, on the card's tensor cores with every f32 value split into three
  bf16 pieces that sum back to it exactly (``split_bf16x3``; the passes
  emulated by ``interleave_onehot_split_plain``, the tiles mirrored by
  ``onehot_plan``); with the one-hot E of ``onehot_expansion`` it is the
  interleave bit for bit.

Each wrapper runs its plain version on a CPU tensor and launches its
kernel, or raises, on a CUDA tensor. ``main()`` runs the three on random
phases (padding random too), checks each against the interleave (K11c
against its own formula) and, on the card, prints each one's device time
and rate with the JAX script's byte count. It needs the card unless it is
given ``device="cpu"`` (then no times).

    python -m nlspn_eccv20_tpu_torch.devtools.microbench_asm
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nlspn_eccv20_tpu_torch.device import resolve_device
from nlspn_eccv20_tpu_torch.devtools.microbench_interleave import (
    B, C, H_OUT, I, J, PADDED, PHASES, W_OUT, check_phases, interleave_window, launch,
    select_phases)
from nlspn_eccv20_tpu_torch.utils.device_time import median_device_time_s

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"interleave_strided_f32": [_P, _P] + [_I] * 3 + [_P],
               "tile_repeat_probe_f32": [_P, _P] + [_I] * 3 + [_P],
               "interleave_onehot_f32": [_P] * 3 + [_I] * 3 + [_P]}
E_SHAPE = (4, J, W_OUT)


def _signature(name):
    fn = f"{name}_f32"
    return {fn: _SIGNATURES[fn]}


# ---- K11b ------------------------------------------------------------------

def interleave_strided_plain(ph: torch.Tensor) -> torch.Tensor:
    """K11b's function as the TPU kernel stores it: out[:, c, a::4, b::4]
    = the phase (a, b) of channel c."""
    check_phases(ph, "interleave_strided")
    out = ph.new_empty(ph.shape[0], C, H_OUT, W_OUT)
    for a in range(4):
        for b in range(4):
            out[:, :, a::4, b::4] = ph[:, (4 * a + b) * C:(4 * a + b + 1) * C, :I, :J]
    return out


STRIDED_THREADS = 128   # K11b's threads a block


def strided_plan(batch: int, hp: int, wp: int, aligned: bool = True):
    """K11b's launch as ``csrc/interleave_strided.cu`` makes it: (blocks,
    threads a block, float4 loads). A thread a (n, c, 4i + a) output row
    and 4-column group q of the window: 19 a row. The float4 form where
    ``wp % 4 == 0`` and the phases are 16-byte aligned (``aligned``), else
    the scalar form."""
    threads = batch * C * H_OUT * (J // 4)
    return -(-threads // STRIDED_THREADS), STRIDED_THREADS, wp % 4 == 0 and aligned


def strided_map(batch: int, hp: int, wp: int):
    """K11b's thread map, as ``csrc/interleave_strided.cu`` computes it:
    (src, dst), int64 arrays (threads, 16): thread t copies the padded
    phases' flat element src[t, 4 b + u] (column 4q + u of plane
    (4a + b) * 8 + c, row i) to the output's flat element dst[t, 4 b + u]
    (column 16q + 4u + b of row 4i + a)."""
    t = np.arange(batch * C * H_OUT * (J // 4), dtype=np.int64)
    q, orow = t % (J // 4), t // (J // 4)
    y = orow % H_OUT
    a, i, nc = y % 4, y // 4, orow // H_OUT
    n, c = nc // C, nc % C
    bb, uu = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    bb, uu = bb.reshape(1, 16), uu.reshape(1, 16)
    plane = n[:, None] * PHASES + (4 * a[:, None] + bb) * C + c[:, None]
    src = (plane * hp + i[:, None]) * wp + 4 * q[:, None] + uu
    dst = orow[:, None] * W_OUT + 16 * q[:, None] + 4 * uu + bb
    return src, dst


def interleave_strided(ph: torch.Tensor) -> torch.Tensor:
    """K11b: padded phases (B, 128, Hp, Wp) -> (B, 8, 232, 304)."""
    if ph.device.type == "cpu":
        return interleave_strided_plain(ph)
    check_phases(ph, "interleave_strided")
    out = launch("interleave_strided", _signature("interleave_strided"), ph)
    interleave_strided.launches += 1
    return out


interleave_strided.launches = 0


# ---- K11c ------------------------------------------------------------------

def tile_repeat_probe_plain(ph: torch.Tensor) -> torch.Tensor:
    """K11c's function as the TPU kernel builds it: each phase's 58x76
    plane tiled 4x4 blockwise and selected where (y % 4, x % 4) = (a, b)."""
    check_phases(ph, "tile_repeat_probe")
    return select_phases(ph, lambda p: p.repeat(1, 1, 4, 4))


def tile_repeat_probe(ph: torch.Tensor) -> torch.Tensor:
    """K11c, a timing probe: padded phases (B, 128, Hp, Wp) ->
    (B, 8, 232, 304) by the blockwise-tile formula (not the interleave)."""
    if ph.device.type == "cpu":
        return tile_repeat_probe_plain(ph)
    check_phases(ph, "tile_repeat_probe")
    out = launch("tile_repeat_probe", _signature("tile_repeat_probe"), ph)
    tile_repeat_probe.launches += 1
    return out


tile_repeat_probe.launches = 0


# ---- K11d ------------------------------------------------------------------

def onehot_expansion(device=None) -> torch.Tensor:
    """The TPU script's lane expansions E (4, 76, 304): E[b, j, 4j + b] = 1."""
    e = np.zeros(E_SHAPE, np.float32)
    for b in range(4):
        e[b, np.arange(J), 4 * np.arange(J) + b] = 1.0
    return torch.from_numpy(e).to(device)


def _check_e(e: torch.Tensor) -> None:
    if tuple(e.shape) != E_SHAPE or e.dtype != torch.float32:
        raise ValueError(f"E {tuple(e.shape)} {e.dtype}: want {E_SHAPE} float32")


def interleave_onehot_plain(ph: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """K11d's function as the TPU kernel computes it: for each row phase a,
    sum_b p2_b @ E_b in f32 over the 8 x 58 rows of the four phases b,
    stored at rows a::4."""
    check_phases(ph, "interleave_onehot")
    _check_e(e)
    n = ph.shape[0]
    out = ph.new_empty(n, C, H_OUT, W_OUT)
    for a in range(4):
        rows = ph.new_zeros(n, C * I, W_OUT)
        for b in range(4):
            p2 = ph[:, (4 * a + b) * C:(4 * a + b + 1) * C, :I, :J].reshape(n, C * I, J)
            rows = rows + torch.matmul(p2, e[b])
        out[:, :, a::4, :] = rows.view(n, C, I, W_OUT)
    return out


# K11d's passes: (piece of the phases, piece of E), summed in this order
# within each k-step of 16 (1 = the leading bf16 piece)
ONEHOT_PASSES = ((3, 1), (2, 2), (1, 3), (2, 1), (1, 2), (1, 1))
ONEHOT_KSTEP = 16
ONEHOT_STEPS = 4 * J // ONEHOT_KSTEP   # 19


def split_bf16x3(x: torch.Tensor):
    """K11d's error-free split of float32 ``x``: (x1, x2, x3), bfloat16
    values held in float32, with (x3 + x2) + x1 == x exactly for every
    finite |x| >= 2^-110 and for 0. x1 is x with its low 16 bits cleared,
    x2 the same of r = x - x1 and x3 of r - x2 (which has no low bits set
    inside that domain), as ``csrc/interleave_onehot.cu`` packs them (its
    header)."""
    mask = torch.tensor(-65536, dtype=torch.int32)   # 0xffff0000

    def top(v):
        return (v.contiguous().view(torch.int32) & mask).view(torch.float32)

    x1 = top(x)
    r = x - x1
    x2 = top(r)
    return x1, x2, top(r - x2)


def onehot_operands(ph: torch.Tensor, e: torch.Tensor):
    """K11d's product: A (4B, 464, 304) [(n, a), 58c + i, 76b + j] from the
    padded phases' window, and E as (304, 304)."""
    b = ph.shape[0]
    a = (ph[:, :, :I, :J].reshape(b, 4, 4, C, I, J).permute(0, 1, 3, 4, 2, 5)
         .reshape(4 * b, C * I, 4 * J))
    return a, e.reshape(4 * J, W_OUT)


def onehot_rows_to_output(d: torch.Tensor) -> torch.Tensor:
    """(4B, 464, 304) rows [(n, a), 58c + i] -> out (B, 8, 232, 304)."""
    b = d.shape[0] // 4
    return d.view(b, 4, C, I, W_OUT).permute(0, 2, 3, 1, 4).reshape(b, C, H_OUT, W_OUT)


def interleave_onehot_split_plain(ph: torch.Tensor, e: torch.Tensor,
                                  passes=ONEHOT_PASSES) -> torch.Tensor:
    """K11d's arithmetic on the CPU, for the tests: A and E split by
    ``split_bf16x3``, and for each k-step of 16 the products of the pieces
    ``passes`` names summed into the f32 sums in that order (the products of
    two bf16 values are exact in f32; the card sums each k-step's 16 in its
    own order)."""
    check_phases(ph, "interleave_onehot_split_plain")
    _check_e(e)
    a, e2 = onehot_operands(ph, e)
    ap, ep = split_bf16x3(a), split_bf16x3(e2)
    acc = ph.new_zeros(a.shape[0], C * I, W_OUT)
    for k0 in range(0, 4 * J, ONEHOT_KSTEP):
        ks = slice(k0, k0 + ONEHOT_KSTEP)
        for i, j in passes:
            acc = acc + torch.matmul(ap[i - 1][:, :, ks], ep[j - 1][ks])
    return onehot_rows_to_output(acc)


def onehot_plan(batch: int, sms: int = 132):
    """K11d's tiles as ``csrc/interleave_onehot.cu`` picks them on a card
    with ``sms`` SMs: 152-wide tiles of the 464 * 4B x 304 product, two
    across. Where the 64 x 152 tiles number at least two an SM and the
    batch is even, a block takes 128 rows (two warpgroups); otherwise a
    cluster of 4 blocks of 64 rows shares a tile, each summing its part of
    the 19 k-steps. Returns {"plan", "bm", "bn", "threads", "kparts":
    [(first k-step, k-steps)], "grid": (column blocks, row blocks),
    "blocks"}."""
    rows = C * I * 4 * batch
    if 2 * (rows // 64) >= 2 * sms and batch % 2 == 0:
        name, wg, kp = "large", 2, 1
    else:
        name, wg, kp = "split", 1, 4
    per = -(-ONEHOT_STEPS // kp)
    parts = [(p * per, min(ONEHOT_STEPS, (p + 1) * per) - p * per) for p in range(kp)]
    bm, bn = 64 * wg, 152
    grid = (W_OUT // bn * kp, rows // bm)
    return {"plan": name, "bm": bm, "bn": bn, "threads": 128 * wg, "kparts": parts,
            "grid": grid, "blocks": grid[0] * grid[1]}


def onehot_tiles(batch: int, sms: int = 132):
    """The output tiles of ``onehot_plan``'s grid: (row0, rows, col0, cols)
    of the 464 * 4B x 304 product, once for each tile (the k-parts of a
    cluster share one)."""
    p = onehot_plan(batch, sms)
    return [(by * p["bm"], p["bm"], bx * p["bn"], p["bn"])
            for by in range(p["grid"][1]) for bx in range(W_OUT // p["bn"])]


def interleave_onehot(ph: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """K11d: padded phases (B, 128, Hp, Wp) and E (4, 76, 304) ->
    (B, 8, 232, 304)."""
    if ph.device.type == "cpu":
        return interleave_onehot_plain(ph, e)
    check_phases(ph, "interleave_onehot")
    _check_e(e)
    out = launch("interleave_onehot", _signature("interleave_onehot"), ph, e)
    interleave_onehot.launches += 1
    return out


interleave_onehot.launches = 0


def interleave_case(gen: torch.Generator, device, b: int, hp: int = PADDED[0],
                    wp: int = PADDED[1], random_e: bool = False):
    """Inputs on which K11a, K11b and K11d are timed on the card, from
    ``gen``: N(0, 1) phases (b, 128, hp, wp) whose padding is random too (a
    read outside the 58x76 window shows) and E, the one-hot expansion or,
    with ``random_e``, N(0, 1). Returns ((ph, e), library): the library call
    is the ``.contiguous()`` copy of the permuted window
    (``interleave_window``), the yardstick of all three."""
    ph = torch.randn((b, PHASES, hp, wp), generator=gen).to(device)
    e = (torch.randn(E_SHAPE, generator=gen) if random_e else onehot_expansion()).to(device)
    return (ph, e), lambda: interleave_window(ph)


def main(device=None, batch=B):
    """The three assemblies on random padded phases: whether each equals
    the interleave (K11c: its own plain version) and, on the card, its
    device time (µs, median of 10 calls) and rate (GB/s). Returns
    {name: {"equal": bool, ...}}."""
    dev = resolve_device(device)
    print(f"device: {dev}", flush=True)
    rng = np.random.default_rng(0)
    ph = torch.from_numpy(rng.standard_normal((batch, PHASES, *PADDED)).astype(np.float32)).to(dev)
    e = onehot_expansion(dev)
    ref = interleave_window(ph)
    runs = [("a) K11b interleave_strided, input-driven stores", interleave_strided, (ph,), ref),
            ("b) K11c tile_repeat_probe, blockwise tile + mask", tile_repeat_probe, (ph,),
             tile_repeat_probe_plain(ph)),
            ("c) K11d interleave_onehot, one-hot expansion GEMM", interleave_onehot, (ph, e),
             ref)]
    nbytes = ref.numel() * 4 * 2   # the JAX script's count: the output, read and written
    results = {}
    for name, fn, args, want in runs:
        row = {"equal": bool(torch.equal(fn(*args), want))}
        line = f"{name:55s}"
        if dev.type == "cuda":
            dt = median_device_time_s(fn, *args, calls=10, warmup=2)
            row.update(us=dt * 1e6, gbps=nbytes / dt / 1e9)
            line += f" {row['us']:9.1f} us  {row['gbps']:6.0f} GB/s"
        print(f"{line}  equal: {row['equal']}", flush=True)
        results[name] = row
    return results


if __name__ == "__main__":
    main()
