"""Times variants of K9b, the small conv's backward, or with ``--forward``
of K9, the small conv, on the card: each a CUDA source with the kernel's C
interface (``csrc/small_conv3x3_bwd.cu`` or ``csrc/small_conv3x3.cu``, or
an edited copy of it in a gitignored directory), built by nvcc with the
repository's flags plus the ``-D`` flags given, and called through ctypes
on the same inputs (``small_conv3x3_bwd_case``, b=12 and b=1 of 228x304,
K=10; with ``--forward`` ``small_conv3x3_case``, b=12 of 228x304 and b=1
of 256x320 with K=10, b=2 of 57x75 with K=26). For each: the largest error
against the plain version in float64 over max |plain|, the call's time
(CUDA-graph replays, ``devtools.measure``) and each CUDA kernel's time
(torch.profiler). With ``--power`` it also samples the card's SM clock and
power draw (nvidia-smi, every 50 ms) while the first variant, then cuDNN's
same function, run back to back for 2 s each. TF32 off, cuDNN in benchmark
mode. Needs the card:

    python -m nlspn_eccv20_tpu_torch.tools.time_k9b_variants [--power] \\
        [--forward] NAME=SOURCE[:FLAG,FLAG...] ...

e.g. ``kernel=nlspn_eccv20_tpu_torch/csrc/small_conv3x3_bwd.cu
cut=build/exp/k9b.cu:-DNOMMA``. One JSON object per variant and shape is
printed, each on its own line.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import os
import subprocess
import time

import torch

from nlspn_eccv20_tpu_torch.devtools.measure import measure
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.small_conv3x3 import (
    small_conv3x3_bwd_case, small_conv3x3_bwd_plain, small_conv3x3_case, small_conv3x3_plain)
from nlspn_eccv20_tpu_torch.tools.profile_kernels import passes_us

_P, _I = ctypes.c_void_p, ctypes.c_int
SHAPES = ((12, 228, 304, 10), (1, 228, 304, 10))
FWD_SHAPES = ((12, 228, 304, 10), (1, 256, 320, 10), (2, 57, 75, 26))


def build_variants(variants, forward=False):
    """{name: loaded library}: one nvcc a variant, all started together."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src, flags in variants:
        out = os.path.join(build.BUILD_DIR, f"libk9b-variant-{name}.so")
        procs[name] = (out, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-I", build.CSRC_DIR, "-o", out,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build {name}] {line.strip()}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(out)
        stem = "small_conv3x3" if forward else "small_conv3x3_bwd"
        getattr(lib, f"{stem}_f32").argtypes = [_P] * (6 if forward else 8) + [_I] * 6 + [_P]
        getattr(lib, f"{stem}_scratch_floats").argtypes = [_I] * 6
        getattr(lib, f"{stem}_scratch_floats").restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def caller(lib, g, xa, xb, wk):
    """A call of the variant's C entry point into outputs made here."""
    b, ca, h, w = xa.shape
    cb, k = xb.shape[1], wk.shape[0]
    dxa, dxb = torch.empty_like(xa), torch.empty_like(xb)
    dwb = torch.empty(k * (ca + cb) * 9 + k, device=xa.device)
    scratch = torch.empty(lib.small_conv3x3_bwd_scratch_floats(b, h, w, ca, cb, k),
                          device=xa.device)

    def call():
        err = lib.small_conv3x3_bwd_f32(
            g.data_ptr(), xa.data_ptr(), xb.data_ptr(), wk.data_ptr(), dxa.data_ptr(),
            dxb.data_ptr(), dwb.data_ptr(), scratch.data_ptr(), b, h, w, ca, cb, k,
            torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "small_conv3x3_bwd variant")
        return dxa, dxb, dwb[:-k].view(wk.shape), dwb[-k:]

    return call


def fwd_caller(lib, xa, xb, wk, bk):
    """A call of a K9 variant's C entry point into an output made here."""
    b, ca, h, w = xa.shape
    cb, k = xb.shape[1], wk.shape[0]
    out = torch.empty((b, k, h, w), device=xa.device)
    scratch = torch.empty(lib.small_conv3x3_scratch_floats(b, h, w, ca, cb, k),
                          device=xa.device)

    def call():
        err = lib.small_conv3x3_f32(
            xa.data_ptr(), xb.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, h, w, ca, cb, k, torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "small_conv3x3 variant")
        return (out,)

    return call


def sample_power(phases, seconds=2.0):
    """For each (name, fn): the SM clock (MHz) and power draw (W) nvidia-smi
    reads while fn runs back to back for ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
    spans = []
    try:
        for name, fn in phases:
            t0 = time.time()
            while time.time() - t0 < seconds:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            spans.append((name, t0 + 0.3, time.time()))
    finally:
        smi.terminate()
    rows = []
    for line in smi.communicate()[0].strip().splitlines():
        ts, clk, pw, limit = (f.strip() for f in line.split(","))
        stamp = datetime.datetime.strptime(ts, "%Y/%m/%d %H:%M:%S.%f").timestamp()
        rows.append((stamp, float(clk), float(pw), limit))
    out = []
    for name, a, b in spans:
        got = [r for r in rows if a <= r[0] <= b]
        clk, pw = [r[1] for r in got], [r[2] for r in got]
        out.append({"power_of": name, "samples": len(got),
                    "sm_clock_mhz": [min(clk), sum(clk) / len(clk), max(clk)] if got else None,
                    "power_w": [min(pw), sum(pw) / len(pw), max(pw)] if got else None,
                    "power_limit_w": got[0][3] if got else None})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--power", action="store_true",
                        help="sample clocks and power while the first variant runs")
    parser.add_argument("--forward", action="store_true",
                        help="time variants of K9, the forward, instead of K9b")
    parser.add_argument("variants", nargs="+", metavar="NAME=SOURCE[:FLAGS]")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_k9b_variants needs the CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    variants = []
    for spec in args.variants:
        name, rest = spec.split("=", 1)
        src, _, flags = rest.partition(":")
        variants.append((name, src, [f for f in flags.split(",") if f]))
    libs = build_variants(variants, args.forward)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    gen = torch.Generator().manual_seed(0)
    case, plain, make_call = ((small_conv3x3_case, small_conv3x3_plain, fwd_caller)
                              if args.forward else
                              (small_conv3x3_bwd_case, small_conv3x3_bwd_plain, caller))
    shapes = FWD_SHAPES if args.forward else SHAPES
    for b, h, w, k in shapes:
        inputs, library = case(gen, dev, b, h, w, k=k)
        want = plain(*(t.double() for t in inputs))
        if args.forward:
            want = (want,)
        for name, _, flags in variants:
            call = make_call(libs[name], *inputs)
            got = call()
            torch.cuda.synchronize()
            rel = max(float((a.double() - r).abs().max() / r.abs().max())
                      for a, r in zip(got, want))
            print(json.dumps({"variant": name, "flags": flags, "batch": b, "shape": [h, w],
                              "k": k, "rel": rel,
                              "ms": 1e3 * measure(call, calls=20, warmup=1),
                              "passes_us": passes_us(call)}), flush=True)
        if args.power and (b, h, w, k) == shapes[0]:
            first = variants[0][0]
            for row in sample_power([(first, make_call(libs[first], *inputs)),
                                     ("cudnn", library)]):
                print(json.dumps(row), flush=True)
        del inputs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
