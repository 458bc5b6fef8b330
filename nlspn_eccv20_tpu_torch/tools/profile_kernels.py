"""Where the time of the redesigned kernels goes, CUDA kernel by CUDA
kernel: the decode_aff tail K2 ``decode_aff_tail``, the GRU refresh's
backwards K4 ``decode_aff_tail_bwd`` and K5 ``dep_encode_front_bwd``, the
offset step's backward K8 ``deform_prop_bwd`` (its two passes), the
encode_dep front K3 ``dep_encode_front``, the constant-affinity loop's
backward K6b ``prop_loop_bwd``, the local step's backward K1b
``prop_step_bwd``, the offset step K7 ``deform_prop``, and the local step
K1 ``prop_step`` (the other candidate for the next redesign).

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
b=12 of 228x304, the train step's 12 launches) it times the whole call and
one PyTorch call sequence of the same function (cuDNN's two convs or their
backward; for K8 the ``grid_sample`` form's backward, for K7 its forward;
for K1 replicate pad, ``F.unfold``, the weighted sum and the blend, for K1b
that form's autograd backward written out; for K6b, which no PyTorch call
computes, 12 launches of K1b, the per-step route) as CUDA-graph replays
(``devtools.measure``), and splits the call's device time into its CUDA
kernels with ``torch.profiler`` (per call, over ``CALLS`` calls). The
inputs are the ones ``chip_smoke.py`` checks the kernels on (the
``*_case`` functions beside the wrappers), from a seeded generator; the
checks themselves are ``chip_smoke.py``'s. TF32 off, cuDNN in benchmark
mode. Needs the CUDA card:

    python -m nlspn_eccv20_tpu_torch.tools.profile_kernels

One JSON object per case is printed, each on its own line.
"""

from __future__ import annotations

import json
import subprocess
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from nlspn_eccv20_tpu_torch.devtools.measure import measure
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    decode_aff_tail, decode_aff_tail_bwd, decode_aff_tail_bwd_case,
    decode_aff_tail_case, decode_aff_tail_fwd_y1)
from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import (
    deform_prop, deform_prop_bwd, deform_prop_bwd_case, deform_prop_case)
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    dep_encode_front, dep_encode_front_bwd, dep_encode_front_bwd_case,
    dep_encode_front_case)
from nlspn_eccv20_tpu_torch.ops.kernels.prop_loop import prop_loop_bwd, prop_loop_bwd_case
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
    prop_step, prop_step_bwd, prop_step_bwd_case, prop_step_case)

CALLS = 10       # calls in the profiled window
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
         ("K1", 12, 228, 304, {}), ("K1", 1, 256, 320, {})]


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
    if kname in ("K1b", "K7", "K1"):
        case = {"K1b": prop_step_bwd_case, "K7": deform_prop_case,
                "K1": prop_step_case}[kname]
        fn = {"K1b": prop_step_bwd, "K7": deform_prop, "K1": prop_step}[kname]
        args, kw, library = case(gen, dev, b, h, w, **opts)
        kernel = lambda: fn(*args, **kw)
    elif kname == "K2":
        args, library = decode_aff_tail_case(gen, dev, b, h, w, opts["k"],
                                             opts.get("c", 256))
        fwd = decode_aff_tail_fwd_y1 if opts.get("y1") else decode_aff_tail
        kernel = lambda: fwd(*args)
    elif kname == "K6b":
        args, kw, library = prop_loop_bwd_case(gen, dev, b, h, w, **opts)
        kernel = lambda: prop_loop_bwd(*args, **kw)
    elif kname == "K4":
        args, library = decode_aff_tail_bwd_case(gen, dev, b, h, w, opts["k"])
        kernel = lambda: decode_aff_tail_bwd(*args)
    elif kname == "K5":
        args, library = dep_encode_front_bwd_case(gen, dev, b, h, w)
        kernel = lambda: dep_encode_front_bwd(*args)
    elif kname == "K8":
        args, kw, library = deform_prop_bwd_case(gen, dev, b, h, w, **opts)
        kernel = lambda: deform_prop_bwd(*args, **kw)
    else:
        args, library = dep_encode_front_case(gen, dev, b, h, w, **opts)
        kernel = lambda: dep_encode_front(*args)
    return {"name": kname, "batch": b, "shape": [h, w], **opts,
            "ms": 1e3 * measure(kernel, calls=20, warmup=1),
            "library_ms": 1e3 * measure(library, calls=20, warmup=1),
            "passes_us": passes_us(kernel)}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_kernels needs the CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    reports = build.build_all(["dec_aff_tail", "dec_aff_tail_bwd", "deform_prop_bwd",
                               "dep_encode_front", "dep_encode_front_bwd",
                               "prop_loop", "prop_loop_bwd", "prop_step_bwd",
                               "prop_step", "deform_prop"])
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
        print(json.dumps(run_case(gen, dev, *case)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
