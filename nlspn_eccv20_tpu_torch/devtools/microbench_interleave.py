"""Kernel K11a, the output-driven 4x4 phase interleave, and the
microbenchmark that times it beside the plain interleaves and deconv0.

Counterpart of the JAX package's ``devtools/microbench_interleave.py``,
which weighs ways to interleave the 16 output phases (4x4 pixel
decimation) of the decode_aff tail's 8-channel affinity into planar
(B, 8, 232, 304):

* K11a (``csrc/interleave_asm.cu``) replaces its TPU kernel ``asm_kernel``
  (reached from ``pallas_asm``), the mask-and-repeat assembly:
  out[n, c, 4i + a, 4j + b] = ph[n, (4a + b) * 8 + c, i, j] for i < 58,
  j < 76, the phases in the first 58 rows and 76 columns of padded planes
  (the TPU's (B, 128, 64, 128)). ``interleave_asm`` is its wrapper;
  ``interleave_asm_plain``, the repeat-and-select assembly in PyTorch, its
  plain version;
* ``interleave``, ``interleave_flat``, ``deinterleave`` and ``to_flat``:
  the script's layout changes, a permute and one copy each;
* ``deconv0``: the decoder's first transposed conv, 128 -> 256 channels at
  stride 2, as ``F.conv_transpose2d`` (cuDNN) with NCHW or channels-last
  tensors, the counterpart of the script's NHWC and NCHW outputs.

The port's decode_aff tail (K2) writes planar output itself, so no model
runs K11a. ``main()`` times every line the JAX script prints, with its byte
counts, through ``utils.device_time``. It needs the card unless it is
given ``device="cpu"`` (then it runs the plain versions, without times).

    python -m nlspn_eccv20_tpu_torch.devtools.microbench_interleave
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu_torch.device import resolve_device
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.utils.device_time import median_device_time_s

C, I, J = 8, 58, 76                  # channels; rows and columns of a phase
PHASES = 16 * C                      # (4a + b) * 8 + c
H_OUT, W_OUT = 4 * I, 4 * J          # 232 x 304
PADDED = (64, 128)                   # the TPU's padded phase planes
B = 12                               # the script's batch

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"interleave_asm_f32": [_P, _P] + [_I] * 3 + [_P]}


def check_phases(ph: torch.Tensor, what: str) -> None:
    """Raise unless ``ph`` is f32 (B, 128, Hp, Wp) with B > 0, Hp >= 58
    and Wp >= 76."""
    if ph.dim() != 4 or ph.shape[0] == 0 or ph.shape[1] != PHASES \
            or ph.shape[2] < I or ph.shape[3] < J:
        raise ValueError(f"{what}: phases {tuple(ph.shape)}, want "
                         f"(B > 0, {PHASES}, >= {I}, >= {J})")
    if ph.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {ph.dtype}")


def launch(name: str, signatures: dict, ph: torch.Tensor, *extra: torch.Tensor) -> torch.Tensor:
    """Launch ``<name>_f32`` of ``csrc/<name>.cu`` on the padded phases
    ``ph`` (and the inputs ``extra``), into a new (B, 8, 232, 304) output."""
    build.check_tensor(ph, f"{name} ph")
    for t in extra:
        build.check_tensor(t, f"{name} input", device=ph.device)
    out = torch.empty(ph.shape[0], C, H_OUT, W_OUT, device=ph.device)
    with torch.cuda.device(ph.device):
        lib = build.load(name, signatures)
        err = getattr(lib, f"{name}_f32")(
            ph.data_ptr(), *(t.data_ptr() for t in extra), out.data_ptr(),
            ph.shape[0], ph.shape[2], ph.shape[3], torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, name)
    return out


def interleave_window(ph: torch.Tensor) -> torch.Tensor:
    """The interleave of the padded phases' 58x76 window: ``interleave_flat``'s
    permute on a view, then one copy."""
    return (ph[:, :, :I, :J].unflatten(1, (4, 4, C)).permute(0, 3, 4, 1, 5, 2)
            .reshape(ph.shape[0], C, H_OUT, W_OUT))


def select_phases(ph: torch.Tensor, expand) -> torch.Tensor:
    """The TPU kernels' mask-and-select assembly: each phase (a, b)'s 8
    channels of the 58x76 window, expanded by ``expand`` to 232x304, kept
    where (y % 4, x % 4) = (a, b)."""
    win = ph[:, :, :I, :J]
    yy = torch.arange(H_OUT, device=ph.device).view(H_OUT, 1) % 4
    xx = torch.arange(W_OUT, device=ph.device).view(1, W_OUT) % 4
    acc = ph.new_zeros(ph.shape[0], C, H_OUT, W_OUT)
    for a in range(4):
        for b in range(4):
            r = expand(win[:, (4 * a + b) * C:(4 * a + b + 1) * C])
            acc = torch.where((yy == a) & (xx == b), r, acc)
    return acc


def interleave_asm_plain(ph: torch.Tensor) -> torch.Tensor:
    """K11a's function as the TPU kernel builds it: each phase repeated x4
    along both axes (each value four times) and selected."""
    check_phases(ph, "interleave_asm")
    return select_phases(ph, lambda p: p.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3))


ASM_ROWS = 8   # K11a's output rows a block: 8 x 76 threads, 19 warps


def asm_plan(batch: int):
    """K11a's launch as ``csrc/interleave_asm.cu`` makes it: (grid, threads
    a block). A block holds 8 output rows of one (n, c); a thread, 4
    adjacent output columns of one row."""
    return (H_OUT // ASM_ROWS, batch * C), ASM_ROWS * J


def asm_map(batch: int, hp: int, wp: int):
    """K11a's thread map, as ``csrc/interleave_asm.cu`` computes it:
    (src, dst), int64 arrays (threads, 4): the thread copies the padded
    phases' flat element src[t, b] (phase b of row y's row phase a, window
    element (y // 4, j)) to the output's flat element dst[t, b] (column
    4j + b of row y), the four stored as one float4."""
    (gx, gy), threads = asm_plan(batch)
    blk_x, nc, t = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(threads),
                               indexing="ij")
    r, j = t // J, t % J
    y = blk_x * ASM_ROWS + r
    n, c = nc // C, nc % C
    a, i = y % 4, y // 4
    b = np.arange(4).reshape(1, 4)
    plane = (n.reshape(-1, 1) * PHASES + 4 * a.reshape(-1, 1) * C + c.reshape(-1, 1)
             + b * C)
    src = (plane * hp + i.reshape(-1, 1)) * wp + j.reshape(-1, 1)
    dst = (nc.reshape(-1, 1) * H_OUT + y.reshape(-1, 1)) * W_OUT + 4 * j.reshape(-1, 1) + b
    return src.astype(np.int64), dst.astype(np.int64)


def interleave_asm(ph: torch.Tensor) -> torch.Tensor:
    """K11a: padded phases (B, 128, Hp, Wp) -> (B, 8, 232, 304). On a CPU
    tensor it runs the plain version; on a CUDA tensor it launches the
    kernel or raises."""
    if ph.device.type == "cpu":
        return interleave_asm_plain(ph)
    check_phases(ph, "interleave_asm")
    out = launch("interleave_asm", _SIGNATURES, ph)
    interleave_asm.launches += 1
    return out


interleave_asm.launches = 0


def interleave(p: torch.Tensor) -> torch.Tensor:
    """(B, 8, 4, 4, 58, 76) [c, a, b, i, j] -> (B, 8, 232, 304)."""
    return p.permute(0, 1, 4, 2, 5, 3).reshape(p.shape[0], C, H_OUT, W_OUT)


def interleave_flat(p: torch.Tensor) -> torch.Tensor:
    """(B, 128, 58 * 76) [(4a + b) * 8 + c, 76 i + j] -> (B, 8, 232, 304)."""
    return (p.reshape(p.shape[0], 4, 4, C, I, J).permute(0, 3, 4, 1, 5, 2)
            .reshape(p.shape[0], C, H_OUT, W_OUT))


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(B, 8, 232, 304) -> (B, 128, 58, 76), the inverse of the interleave."""
    return (x.reshape(x.shape[0], C, I, 4, J, 4).permute(0, 3, 5, 1, 2, 4)
            .reshape(x.shape[0], PHASES, I, J))


def to_flat(y: torch.Tensor) -> torch.Tensor:
    """NHWC (B, 58, 76, 256) -> flat planar (B, 256, 58 * 76), laid out so
    in memory (the permute alone would be a view)."""
    return y.permute(0, 3, 1, 2).reshape(y.shape[0], y.shape[3], I * J).contiguous()


def deconv0_weight(k: torch.Tensor) -> torch.Tensor:
    """The JAX script's HWIO kernel of its lhs-dilated conv -> the
    (in, out, kh, kw) weight of ``F.conv_transpose2d``: flipped in space."""
    return torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()


def deconv0(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, 128, 29, 38) -> (B, 256, 58, 76): k3, stride 2, padding 1,
    output padding 1, no bias. The output keeps ``x``'s memory format
    (NCHW, or channels-last when ``x`` and ``w`` are)."""
    return F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)


def main(device=None, batch=B):
    """Every line of the JAX script: on the card its device time (µs, the
    median of 10 calls) and rate (GB/s) where the script counts bytes. Also
    whether K11a equals the interleave of its window (padding random), and
    the largest relative difference between deconv0's NCHW and
    channels-last outputs. Returns {"lines": {name: {...}}, "asm_equal":
    bool, "deconv0_rel": float}."""
    dev = resolve_device(device)
    print(f"device: {dev}", flush=True)
    rng = np.random.default_rng(0)

    def randn(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

    ph = randn(batch, C, 4, 4, I, J)
    nbytes = ph.numel() * 4 * 2
    phf = randn(batch, PHASES, I * J)
    g = randn(batch, C, H_OUT, W_OUT)
    php = randn(batch, PHASES, *PADDED)
    x = randn(batch, 29, 38, 128).permute(0, 3, 1, 2)
    w = deconv0_weight(randn(3, 3, 128, 256, std=0.03))
    x_nchw, x_cl = x.contiguous(), x.contiguous(memory_format=torch.channels_last)
    w_cl = w.contiguous(memory_format=torch.channels_last)
    y = randn(batch, I, J, 256)
    lines = [("planar interleave 4x4, permute + copy (27MB)", interleave, (ph,), nbytes),
             ("flat->planar interleave, permute + copy (27MB)", interleave_flat, (phf,), nbytes),
             ("planar de-interleave, permute + copy (27MB)", deinterleave, (g,), nbytes),
             ("K11a interleave_asm, output-driven (27MB)", interleave_asm, (php,), nbytes),
             ("deconv0 128->256 channels-last out", deconv0, (x_cl, w_cl), None),
             ("deconv0 128->256 NCHW out", deconv0, (x_nchw, w), None),
             ("NHWC->flat-planar transpose, permute + copy (54MB)", to_flat, (y,),
              y.numel() * 8)]
    results = {"lines": {}}
    for name, fn, args, nb in lines:
        row = {}
        if dev.type == "cuda":
            dt = median_device_time_s(fn, *args, calls=10, warmup=2)
            row["us"] = dt * 1e6
            if nb:
                row["gbps"] = nb / dt / 1e9
        results["lines"][name] = row
        rate = f"{row['gbps']:6.0f} GB/s" if "gbps" in row else ""
        time_ = f"{row['us']:9.1f} us" if "us" in row else "         -"
        print(f"{name:55s} {time_}  {rate}", flush=True)
    results["asm_equal"] = bool(torch.equal(interleave_asm(php), interleave_window(php)))
    ref = deconv0(x_nchw, w)
    results["deconv0_rel"] = ((deconv0(x_cl, w_cl) - ref).abs().max()
                              / ref.abs().max()).item()
    print(f"K11a equals the interleave of its window: {results['asm_equal']}; "
          f"deconv0 channels-last vs NCHW: rel {results['deconv0_rel']:.2e}", flush=True)
    return results


if __name__ == "__main__":
    main()
