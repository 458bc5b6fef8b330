"""Kernels K11b, K11c and K11d: three ways to assemble the 4x4 phases,
and the microbenchmark that times them.

Counterpart of the JAX package's ``devtools/microbench_asm.py``. Input: 16
phases x 8 channels in the first 58 rows and 76 columns of padded planes,
(B, 128, Hp, Wp) (the TPU's (B, 128, 64, 128)); output (B, 8, 232, 304):

* K11b (``csrc/interleave_strided.cu``) replaces the TPU kernel
  ``k_strided``: the interleave out[n, c, 4i + a, 4j + b] =
  ph[n, (4a + b) * 8 + c, i, j], written input-driven, each phase element
  stored 4 floats from its neighbour as the TPU's strided stores;
* K11c (``csrc/tile_repeat_probe.cu``) replaces ``k_repeat``, a timing
  probe and not an interleave: ``pltpu.repeat`` tiles the plane blockwise,
  so out[n, c, y, x] = ph[n, ((y % 4) * 4 + x % 4) * 8 + c, y % 58, x % 76];
  it is held to that formula only;
* K11d (``csrc/interleave_onehot.cu``) replaces ``k_matmul``, the lane
  expansion by one-hot products: out[n, c, 4i + a, x] =
  sum_b sum_j ph[n, (4a + b) * 8 + c, i, j] * E[b, j, x], a GEMM of depth
  304 in plain f32 FMAs; with the one-hot E of ``onehot_expansion`` it is
  the interleave bit for bit.

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
