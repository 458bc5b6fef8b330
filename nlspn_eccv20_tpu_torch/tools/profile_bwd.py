"""Where the time of the GRU refresh's two backward kernels goes, pass by
pass: K4 ``decode_aff_tail_bwd`` and K5 ``dep_encode_front_bwd``.

For each case (the train step's shapes at b=12 and b=1, then the shapes
that ``chip_smoke.py`` phase 4 also checks: K4 with K=24, on an odd base
grid 58x75 and on KITTI's 60x304, K5 on an unaligned 230x306 plane and at
KITTI's 240x1216) it times the whole call and cuDNN's backward of the same
two convs (CUDA-graph replays, ``devtools.measure``), and splits the call's
device time into its CUDA kernels with ``torch.profiler`` (per call, over
``CALLS`` calls). The inputs are the ones ``chip_smoke.py`` checks the
kernels on (``decode_aff_tail_bwd_case``, ``dep_encode_front_bwd_case``),
from a seeded generator; the checks themselves are ``chip_smoke.py``'s.
TF32 off, cuDNN in benchmark mode. Needs the CUDA card:

    python -m nlspn_eccv20_tpu_torch.tools.profile_bwd

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
    decode_aff_tail_bwd, decode_aff_tail_bwd_case)
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    dep_encode_front_bwd, dep_encode_front_bwd_case)

CALLS = 10       # calls in the profiled window
# (kernel, batch, height, width, K): K4's base grid or K5's plane
CASES = [("K4", 12, 58, 76, 8), ("K5", 12, 228, 304, None),
         ("K4", 1, 58, 76, 8), ("K5", 1, 228, 304, None),
         ("K4", 1, 58, 76, 24), ("K5", 2, 230, 306, None),
         ("K5", 1, 240, 1216, None), ("K4", 1, 60, 304, 8),
         ("K4", 1, 58, 75, 8)]


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
            us[name.split(" ")[-1].split("::")[-1]] += t / CALLS
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))


def run_case(gen, dev, kname, b, h, w, k):
    if kname == "K4":
        args, library = decode_aff_tail_bwd_case(gen, dev, b, h, w, k)
        kernel = lambda: decode_aff_tail_bwd(*args)
    else:
        args, library = dep_encode_front_bwd_case(gen, dev, b, h, w)
        kernel = lambda: dep_encode_front_bwd(*args)
    return {"kernel": kname, "batch": b, "shape": [h, w], "K": k,
            "ms": 1e3 * measure(kernel, calls=20, warmup=1),
            "library_ms": 1e3 * measure(library, calls=20, warmup=1),
            "passes_us": passes_us(kernel)}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_bwd needs the CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    reports = build.build_all(["dec_aff_tail", "dec_aff_tail_bwd",
                               "dep_encode_front", "dep_encode_front_bwd"])
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
