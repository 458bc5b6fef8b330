"""Where the time of the redesigned kernels goes, CUDA kernel by CUDA
kernel: the decode_aff tail K2 ``decode_aff_tail``, the GRU refresh's
backwards K4 ``decode_aff_tail_bwd`` and K5 ``dep_encode_front_bwd``, the
offset step's backward K8 ``deform_prop_bwd`` (its two passes), the
encode_dep front K3 ``dep_encode_front``, the constant-affinity loop's
backward K6b ``prop_loop_bwd``, the local step's backward K1b
``prop_step_bwd``, the offset step K7 ``deform_prop``, the local step K1
``prop_step`` and the constant-affinity loop K6 ``prop_loop``.

For each case (the train step's shapes at b=12 and b=1 and the serving
shapes at b=1 and b=4, then the shapes that ``chip_smoke.py`` also checks:
K2 at KITTI's 60x304 base grid, with K=24, on an odd 57x75 one and with
C=40, K4 with K=24, on an odd base grid 58x75 and on KITTI's 60x304, K5
on an unaligned 230x306 plane and at KITTI's 240x1216, K8 at KITTI's
240x1216, with 5x5 neighbours and on converging offsets, K3 at KITTI's
240x1216 and with C1 = 96, K6b with 5x5 neighbours and on a 230x306
plane, K1b with the clip on (its ties), on a 230x306 plane, at KITTI's
240x1216 and with 5x5 neighbours, K7 at the serving shapes with eval
offsets past the window, at b=12 clamped to R=4 and with offsets far past
it, at KITTI's 240x1216, with 5x5 neighbours and on a 230x306 plane, K1 at
b=12 of 228x304, the train step's 12 launches, at the serving shapes, at
KITTI's 240x1216, with 5x5 neighbours and on a 230x306 plane, and K6
``prop_loop``, the constant-affinity loop, at the serving shapes, at b=12
of 228x304, at KITTI's 240x1216, with 5x5 neighbours, with 18 steps, and
in its training form at b=12, which also writes the 12 step inputs; the
interleave microbenchmark's K11a ``interleave_asm``, K11b
``interleave_strided`` and K11d ``interleave_onehot`` at b=12 and b=1 of
the TPU's (64, 128) padded phases and at b=12 of unaligned (59, 77) ones,
which take the kernels' scalar forms; the op library's K9
``small_conv3x3`` and K9b ``small_conv3x3_bwd`` at b=12 and b=1 of
228x304 with K=10, at b=2 of an odd 57x75 plane with K=26 and with K=1,
K9 also at the serving shapes, b=1 and b=4 of 256x320; the devtools'
K10b ``deform_colgather`` at NYU's b=12 of 228x304 and KITTI's b=1 of
240x1216, and K10a ``deform_windowed`` at the same two and with 5x5
neighbours at b=1 of 228x304, on the experiment's offsets clip(N(0,
1.5^2), -4, 4); and the bf16 forms ``K2-bf16``, ``K3-bf16``, ``K4-bf16``,
``K5-bf16``, ``K9-bf16`` and ``K9b-bf16``: K2-bf16 at b=12 of the 58x76 base
grid with y1 written (as training runs it) and without, and at b=1 and b=4
of 64x80, also with K=24 at b=1, K3-bf16 at b=12 of 228x304, at b=1 and
b=4 of 256x320 and at KITTI's 240x1216 (its weight layout,
``prep_front_w1_kernel``, a pass of its own), K4-bf16 at b=12 and b=1 of
the base grid with K=8 and K=24, K5-bf16 at b=12 and b=1 of 228x304,
K9-bf16 at b=1 and b=4 of
256x320, b=12 of 228x304 and b=2 of 57x75 with K=26 (its rows padded to a
multiple of 8 columns by ``pad_rows_kernel``, a pass of its own),
K9b-bf16 at b=12 and b=1 of 228x304
and b=2 of 57x75 and of 57x76 with K=26 (its passes: the weight layout
``prep_weights_kernel``, the padded copy ``pad_rows_kernel`` where W % 8 !=
0, ``dx_kernel``, ``wgrad_kernel`` and the reduction), their yardsticks
cuDNN's bf16 calls) it
times the whole call and one PyTorch call sequence of the same function (cuDNN's two convs or their
backward; for K8 the ``grid_sample`` form's backward, for K7 its forward;
for K1 replicate pad, ``F.unfold``, the weighted sum and the blend, for K1b
that form's autograd backward written out; for K6b, which no PyTorch call
computes, 12 launches of K1b, the per-step route; for K6 likewise 12
launches of K1; for K11a, K11b and K11d the ``.contiguous()`` copy of the
permuted window, and for K11d also, as ``matmul_ms``, ``torch.matmul`` of
the same 4B GEMMs on operands laid out for it beforehand; for K9 the
``F.conv2d`` over the concat, for K9b cuDNN's backward of it; for K10b and K10a the
exact gather through ``F.grid_sample`` and the weighted sum) as CUDA-graph replays
(``devtools.measure``), and splits the call's device time into its CUDA
kernels with ``torch.profiler`` (per call, over ``CALLS`` calls). The
inputs are the ones ``chip_smoke.py`` checks the kernels on (the
``*_case`` functions beside the wrappers), from a seeded generator; the
checks themselves are ``chip_smoke.py``'s. TF32 off, cuDNN in benchmark
mode. Needs the CUDA card:

    python -m nlspn_eccv20_tpu_torch.tools.profile_kernels [K1 K6 ...]

(the names given restrict it to those kernels' cases). One JSON object per
case is printed, each on its own line. Sources a tree lacks are left out of
the build, so the same script times an older tree's kernels when it is
copied into that tree (K2-bf16 and K3-bf16 were ``dec_aff_tail.cu`` and
``dep_encode_front.cu`` at a bf16 element type before they had their own
sources).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from collections import defaultdict

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from nlspn_eccv20_tpu_torch.devtools.exp_deform3 import deform_colgather, deform_colgather_case
from nlspn_eccv20_tpu_torch.devtools.exp_deform_prop_kernel import (
    deform_windowed, deform_windowed_case)
from nlspn_eccv20_tpu_torch.devtools.measure import measure
from nlspn_eccv20_tpu_torch.devtools.microbench_asm import (
    interleave_case, interleave_onehot, interleave_strided, onehot_operands)
from nlspn_eccv20_tpu_torch.devtools.microbench_interleave import interleave_asm
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    decode_aff_tail, decode_aff_tail_bwd, decode_aff_tail_bwd_case,
    decode_aff_tail_case, decode_aff_tail_fwd_y1)
from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import (
    deform_prop, deform_prop_bwd, deform_prop_bwd_case, deform_prop_case)
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    dep_encode_front, dep_encode_front_bwd, dep_encode_front_bwd_case,
    dep_encode_front_case)
from nlspn_eccv20_tpu_torch.ops.kernels.prop_loop import (
    launch_fwd as prop_loop_fwd, prop_loop_bwd, prop_loop_bwd_case, prop_loop_case)
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
    prop_step, prop_step_bwd, prop_step_bwd_case, prop_step_case)
from nlspn_eccv20_tpu_torch.ops.kernels.small_conv3x3 import (
    small_conv3x3_bwd, small_conv3x3_bwd_case, small_conv3x3_case, small_conv3x3_planar)

CALLS = 10       # calls in the profiled window
# the sources each kernel's case launches (its yardstick's too)
SOURCES = {"K1": ["prop_step"], "K1b": ["prop_step", "prop_step_bwd"], "K2": ["dec_aff_tail"],
           "K3": ["dep_encode_front"], "K4": ["dec_aff_tail_bwd"],
           "K5": ["dep_encode_front_bwd"], "K6": ["prop_loop", "prop_step"],
           "K6b": ["prop_loop", "prop_loop_bwd", "prop_step_bwd"], "K7": ["deform_prop"],
           "K8": ["deform_prop_bwd"], "K9": ["small_conv3x3"], "K9b": ["small_conv3x3_bwd"],
           "K10a": ["deform_windowed"], "K10b": ["deform_colgather"],
           "K11a": ["interleave_asm"],
           "K11b": ["interleave_strided"], "K11d": ["interleave_onehot"],
           "K2-bf16": ["dec_aff_tail", "dec_aff_tail_bf16"],
           "K3-bf16": ["dep_encode_front", "dep_encode_front_bf16"],
           "K4-bf16": ["dec_aff_tail_bwd"], "K5-bf16": ["dep_encode_front_bwd"],
           "K9-bf16": ["small_conv3x3_bf16"], "K9b-bf16": ["small_conv3x3_bwd_bf16"]}
# (kernel, batch, height, width, options): K2's and K4's base grid (options:
# K, C; K2's y1: the intermediate written, as in training), K5's and K3's
# plane (options: C1), K8's and K6b's plane (options: kernel, converge)
CASES = [("K2", 12, 58, 76, {"k": 8, "y1": True}), ("K2", 12, 58, 76, {"k": 8}),
         ("K2", 1, 64, 80, {"k": 8}), ("K2", 4, 64, 80, {"k": 8}),
         ("K6b", 12, 228, 304, {}), ("K6b", 1, 228, 304, {}),
         ("K4", 12, 58, 76, {"k": 8}), ("K5", 12, 228, 304, {}),
         ("K4", 1, 58, 76, {"k": 8}), ("K5", 1, 228, 304, {}),
         ("K8", 12, 228, 304, {}), ("K8", 1, 228, 304, {}),
         ("K3", 12, 228, 304, {}), ("K3", 1, 256, 320, {}),
         ("K3", 4, 256, 320, {}),
         ("K4", 1, 58, 76, {"k": 24}), ("K5", 2, 230, 306, {}),
         ("K5", 1, 240, 1216, {}), ("K4", 1, 60, 304, {"k": 8}),
         ("K4", 1, 58, 75, {"k": 8}),
         ("K8", 1, 240, 1216, {}), ("K8", 1, 228, 304, {"kernel": 5}),
         ("K8", 12, 228, 304, {"converge": True}),
         ("K3", 1, 240, 1216, {}), ("K3", 1, 228, 304, {"c": 96}),
         ("K2", 1, 60, 304, {"k": 8}), ("K2", 1, 64, 80, {"k": 24}),
         ("K2", 1, 57, 75, {"k": 8}), ("K2", 1, 64, 80, {"k": 8, "c": 40}),
         ("K6b", 1, 228, 304, {"kernel": 5}), ("K6b", 12, 230, 306, {}),
         ("K1b", 12, 228, 304, {}), ("K1b", 1, 228, 304, {}),
         ("K1b", 12, 228, 304, {"clip": True}), ("K1b", 12, 230, 306, {}),
         ("K1b", 1, 240, 1216, {}), ("K1b", 1, 228, 304, {"kernel": 5}),
         ("K7", 1, 256, 320, {}), ("K7", 4, 256, 320, {}),
         ("K7", 12, 228, 304, {"radius": 4}), ("K7", 1, 240, 1216, {}),
         ("K7", 1, 256, 320, {"kernel": 5}), ("K7", 12, 230, 306, {"radius": 4}),
         ("K7", 12, 228, 304, {"off_std": 12.0}),
         ("K1", 12, 228, 304, {}), ("K1", 1, 256, 320, {}), ("K1", 4, 256, 320, {}),
         ("K1", 1, 240, 1216, {}), ("K1", 1, 256, 320, {"kernel": 5}),
         ("K1", 12, 230, 306, {}),
         ("K6", 1, 256, 320, {}), ("K6", 4, 256, 320, {}), ("K6", 12, 228, 304, {}),
         ("K6", 1, 240, 1216, {}), ("K6", 1, 256, 320, {"kernel": 5}),
         ("K6", 1, 256, 320, {"steps": 18}), ("K6", 12, 228, 304, {"save": True}),
         *((k, b, hp, wp, {}) for k in ("K11a", "K11b", "K11d")
           for b, hp, wp in ((12, 64, 128), (1, 64, 128), (12, 59, 77))),
         *((k, b, h, w, {"k": kk}) for k in ("K9b", "K9")
           for b, h, w, kk in ((12, 228, 304, 10), (1, 228, 304, 10), (2, 57, 75, 26),
                               (1, 228, 304, 1))),
         ("K9", 1, 256, 320, {"k": 10}), ("K9", 4, 256, 320, {"k": 10}),
         ("K10b", 12, 228, 304, {}), ("K10b", 1, 240, 1216, {}),
         ("K10a", 12, 228, 304, {}), ("K10a", 1, 240, 1216, {}),
         ("K10a", 1, 228, 304, {"kernel": 5}),
         ("K2-bf16", 12, 58, 76, {"k": 8, "y1": True}), ("K2-bf16", 12, 58, 76, {"k": 8}),
         ("K2-bf16", 1, 64, 80, {"k": 8}), ("K2-bf16", 4, 64, 80, {"k": 8}),
         ("K2-bf16", 1, 64, 80, {"k": 24}),
         ("K3-bf16", 12, 228, 304, {}), ("K3-bf16", 1, 256, 320, {}),
         ("K3-bf16", 4, 256, 320, {}), ("K3-bf16", 1, 240, 1216, {}),
         *(("K4-bf16", b, 58, 76, {"k": k}) for b in (12, 1) for k in (8, 24)),
         ("K5-bf16", 12, 228, 304, {}), ("K5-bf16", 1, 228, 304, {}),
         ("K9-bf16", 1, 256, 320, {"k": 10}), ("K9-bf16", 4, 256, 320, {"k": 10}),
         *((k, b, h, w, {"k": kk}) for k in ("K9-bf16", "K9b-bf16")
           for b, h, w, kk in ((12, 228, 304, 10), (2, 57, 75, 26))),
         ("K9b-bf16", 1, 228, 304, {"k": 10}), ("K9b-bf16", 2, 57, 76, {"k": 26})]
# (K11's height and width are those of the padded phase planes; K9's and
# K9b's options: K, the outputs, beside the heads' Ca = 192 and Cb = 64;
# K10a's: the stencil)


def onehot_matmul(ph, e):
    """K11d's 4B GEMMs as one ``torch.matmul`` on operands laid out for it
    beforehand (``onehot_operands``, made contiguous)."""
    a, e2 = (t.contiguous() for t in onehot_operands(ph, e))
    return lambda: torch.matmul(a, e2)


def bf16_tail_library(x, w1, b1, w2, b2):
    """cuDNN's two bf16 transposed convs with the ReLU between them, on x
    already in NCHW."""
    xn = x.permute(0, 3, 1, 2).contiguous()
    w1b, b1b, w2b, b2b = (t.to(torch.bfloat16) for t in (w1, b1, w2, b2))
    return lambda: F.conv_transpose2d(F.relu(F.conv_transpose2d(xn, w1b, b1b, 2, 1, 1)),
                                      w2b, b2b, 2, 1, 1)


def bf16_front_library(plane, w0, b0, w1, b1):
    """cuDNN's two bf16 convs with their ReLUs, NCHW out."""
    p4 = plane[:, None]
    w0b, b0b, w1b, b1b = (t.to(torch.bfloat16) for t in (w0, b0, w1, b1))
    return lambda: F.relu(F.conv2d(F.relu(F.conv2d(p4, w0b, b0b, 2, 1)), w1b, b1b, 2, 1))


def passes_us(fn):
    """Device time per call of each CUDA kernel that ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    us = defaultdict(float)
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(a, "self_device_time_total", 0.0) or a.self_cuda_time_total
            name = a.key.replace("(anonymous namespace)::", "").split("(")[0]
            us[name.removeprefix("void ").split("::")[-1]] += t / CALLS
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))


def run_case(gen, dev, kname, b, h, w, opts):
    if kname.endswith("-bf16"):   # the bf16 form, through the same entry points
        opts = {**opts, "dtype": torch.bfloat16}
    if kname in ("K1b", "K7", "K1"):
        case = {"K1b": prop_step_bwd_case, "K7": deform_prop_case,
                "K1": prop_step_case}[kname]
        fn = {"K1b": prop_step_bwd, "K7": deform_prop, "K1": prop_step}[kname]
        args, kw, library = case(gen, dev, b, h, w, **opts)
        kernel = lambda: fn(*args, **kw)
    elif kname in ("K2", "K2-bf16"):
        args, library = decode_aff_tail_case(gen, dev, b, h, w, opts["k"],
                                             opts.get("c", 256))
        if kname == "K2-bf16":   # bf16 x; the yardstick cuDNN's bf16 pair
            args = (args[0].to(torch.bfloat16),) + args[1:]
            library = bf16_tail_library(*args)
        fwd = decode_aff_tail_fwd_y1 if opts.get("y1") else decode_aff_tail
        kernel = lambda: fwd(*args)
    elif kname == "K6":
        args, kw, library = prop_loop_case(gen, dev, b, h, w, **opts)
        kernel = lambda: prop_loop_fwd(*args, **kw)
    elif kname == "K6b":
        args, kw, library = prop_loop_bwd_case(gen, dev, b, h, w, **opts)
        kernel = lambda: prop_loop_bwd(*args, **kw)
    elif kname in ("K4", "K4-bf16"):
        args, library = decode_aff_tail_bwd_case(gen, dev, b, h, w, opts["k"],
                                                 dtype=opts.get("dtype", torch.float32))
        kernel = lambda: decode_aff_tail_bwd(*args)
    elif kname in ("K5", "K5-bf16"):
        args, library = dep_encode_front_bwd_case(gen, dev, b, h, w,
                                                  dtype=opts.get("dtype", torch.float32))
        kernel = lambda: dep_encode_front_bwd(*args)
    elif kname == "K8":
        args, kw, library = deform_prop_bwd_case(gen, dev, b, h, w, **opts)
        kernel = lambda: deform_prop_bwd(*args, **kw)
    elif kname in ("K9", "K9b", "K9-bf16", "K9b-bf16"):
        fwd = kname.startswith("K9-") or kname == "K9"
        case = small_conv3x3_case if fwd else small_conv3x3_bwd_case
        fn = small_conv3x3_planar if fwd else small_conv3x3_bwd
        args, library = case(gen, dev, b, h, w, **opts)
        kernel = lambda: fn(*args)
    elif kname == "K10b":
        args, library = deform_colgather_case(gen, dev, b, h, w)
        kernel = lambda: deform_colgather(*args)
    elif kname == "K10a":
        args, library = deform_windowed_case(gen, dev, b, h, w, **opts)
        kernel = lambda: deform_windowed(*args)
    elif kname in ("K11a", "K11b", "K11d"):
        (ph, e), library = interleave_case(gen, dev, b, h, w)
        kernel = {"K11a": lambda: interleave_asm(ph), "K11b": lambda: interleave_strided(ph),
                  "K11d": lambda: interleave_onehot(ph, e)}[kname]
    else:
        args, library = dep_encode_front_case(
            gen, dev, b, h, w, **{k: v for k, v in opts.items() if k != "dtype"})
        if kname == "K3-bf16":   # a bf16 plane; the yardstick cuDNN's bf16 pair
            args = (args[0].to(torch.bfloat16),) + args[1:]
            library = bf16_front_library(*args)
        kernel = lambda: dep_encode_front(*args)
    opts = {k: v for k, v in opts.items() if k != "dtype"}
    row = {"name": kname, "batch": b, "shape": [h, w], **opts,
           "ms": 1e3 * measure(kernel, calls=20, warmup=1),
           "library_ms": 1e3 * measure(library, calls=20, warmup=1)}
    if kname == "K11d":
        row["matmul_ms"] = 1e3 * measure(onehot_matmul(ph, e), calls=20, warmup=1)
    return {**row, "passes_us": passes_us(kernel)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("kernels", nargs="*", choices=sorted(SOURCES), metavar="KERNEL",
                        help="run only these kernels' cases (e.g. K1 K6); all by default")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_kernels needs the CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    names = args.kernels or list(SOURCES)
    have = set(build.kernel_names())
    reports = build.build_all(sorted({src for k in names for src in SOURCES[k]} & have))
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card}),
          flush=True)
    gen = torch.Generator().manual_seed(0)
    for case in CASES:
        if args.kernels and case[0] not in args.kernels:
            continue
        print(json.dumps(run_case(gen, dev, *case)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
