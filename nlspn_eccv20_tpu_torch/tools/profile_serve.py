"""Where the serving forward's time goes on the card, op by op.

Runs the fork-default model (random weights from a seeded generator) at
NYU size (228x304 requests in the 256x320 bucket) under ``torch.profiler``
for b=1 and b=4 and prints, per batch size: the forward's time from CUDA
events, the device's busy time and idle share over the profiled window,
the device time by group (the port's forward kernels, convolutions, the
rest), and the top kernels by device time. ``--offset`` runs the non-local
propagation (``Config(offset=True)``) instead, ``--loop`` the
constant-affinity configuration (``Config(use_GRU=False,
prop_impl="pallas")``, the whole loop one ``prop_loop`` launch). TF32 stays
off, as in ``chip_smoke.py``. Needs the CUDA card:

    python -m nlspn_eccv20_tpu_torch.tools.profile_serve [--offset | --loop] [--cudnn-heuristics]

By default cuDNN times its algorithms for each conv shape first
(``torch.backends.cudnn.benchmark``), as ``Predictor.predict_batch`` has it
do; ``--cudnn-heuristics`` leaves cuDNN to pick by heuristics, to measure
what benchmark mode saves.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.serve import Predictor
from nlspn_eccv20_tpu_torch.utils.weights import randomize_

OUR_KERNELS = ("prop_step_kernel", "deform_prop_kernel", "prop_loop_kernel",
               "dec_aff_tail_kernel", "dep_encode_front_kernel")
ITERS = 5          # forwards in the profiled window
LOOP = dict(use_GRU=False, prop_impl="pallas")   # the whole-loop route


def config_of(args) -> Config:
    """The configuration ``--offset`` or ``--loop`` names, else Config()."""
    return Config(offset=args.offset, **(LOOP if args.loop else {}))


def add_config_options(ap: argparse.ArgumentParser) -> None:
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--offset", action="store_true")
    which.add_argument("--loop", action="store_true")


def group_of(name: str) -> str:
    for k in OUR_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if any(s in low for s in ("conv", "cudnn", "implicit", "gemm", "sm90",
                              "xmma", "wgrad", "dgrad", "winograd", "fft")):
        return "convolutions (cuDNN)"
    return "other (elementwise, pooling, copies, cat)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cudnn-heuristics", action="store_true")
    add_config_options(ap)
    ap.add_argument("--trace-dir", default="chiprun_out")
    args = ap.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = not args.cudnn_heuristics
    cfg = config_of(args)
    model = randomize_(get_model(cfg), torch.Generator().manual_seed(1))
    predictor = Predictor(cfg, state_dict=model.state_dict())  # the card or raise
    del model
    rng = np.random.default_rng(2)
    tag = "cudnn-heuristics" if args.cudnn_heuristics else "cudnn-benchmark"
    if args.offset or args.loop:
        tag += "_offset" if args.offset else "_loop"
    report = {"device": torch.cuda.get_device_name(0), "mode": tag}

    for b in (1, 4):
        rgbs = [rng.integers(0, 256, (228, 304, 3), dtype=np.uint8) for _ in range(b)]
        deps = [np.where(rng.random((228, 304)) < 0.007,
                         rng.uniform(0.5, 10.0, (228, 304)), 0.0).astype(np.float32)
                for _ in range(b)]
        sample, _ = predictor.make_sample(rgbs, deps)
        with torch.inference_mode():
            for _ in range(3):
                predictor.model(sample, need_inter=False)
            torch.cuda.synchronize()
            fwd = []
            for _ in range(11):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                predictor.model(sample, need_inter=False)
                end.record()
                end.synchronize()
                fwd.append(start.elapsed_time(end))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(ITERS):
                    predictor.model(sample, need_inter=False)
                end.record()
                end.synchronize()
            window_ms = start.elapsed_time(end)

        # device-side entries of the profile: one per kernel name
        kernels = [a for a in prof.key_averages()
                   if a.device_type == torch.autograd.DeviceType.CUDA]
        busy = defaultdict(float)
        count = defaultdict(int)
        by_name = defaultdict(float)
        for a in kernels:
            us = getattr(a, "self_device_time_total", 0.0) or a.self_cuda_time_total
            busy[group_of(a.key)] += us
            count[group_of(a.key)] += a.count
            by_name[a.key] += us
        total_ms = sum(busy.values()) / 1e3 / ITERS
        row = {
            "batch": b,
            "forward_ms_median": sorted(fwd)[5],
            "profiled_window_ms_per_forward": window_ms / ITERS,
            "device_busy_ms_per_forward": total_ms,
            "device_idle_share": 1.0 - total_ms / (window_ms / ITERS),
            "kernel_launches_per_forward": sum(count.values()) / ITERS,
            "groups_ms_per_forward": {g: v / 1e3 / ITERS for g, v in
                                      sorted(busy.items(), key=lambda kv: -kv[1])},
            "group_launches_per_forward": {g: n / ITERS for g, n in count.items()},
            "top_kernels_ms_per_forward": [
                (n[:90], v / 1e3 / ITERS) for n, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:15]],
        }
        report[f"b{b}"] = row
        print(json.dumps(row, indent=1), flush=True)
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, f"trace_{tag}_b{b}.json"))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
