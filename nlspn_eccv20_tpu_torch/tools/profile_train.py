"""Where the train step's time goes on the card, op by op.

Runs ``train.Engine`` on the fork-default ``Config()``, with ``--offset``
on ``Config(offset=True)``, or with ``--loop`` on the constant-affinity
``Config(use_GRU=False, prop_impl="pallas")`` (batch 12 of 228x304
synthetic patches, Adam; random weights from a seeded generator) under
``torch.profiler`` and prints: the step's time from CUDA events, the peak
memory, the device's busy time and idle share over the profiled window,
the device time by group (the port's forward and backward kernels,
convolutions, the optimizer, the rest), and the top kernels by device
time, and writes the chrome trace into ``--trace-dir`` (default
``build/``). TF32 stays off, as in ``chip_smoke.py``; cuDNN runs in
benchmark mode, as ``Engine.train_step`` scopes it. Needs the CUDA card:

    python -m nlspn_eccv20_tpu_torch.tools.profile_train [--offset | --loop] [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic
from nlspn_eccv20_tpu_torch.tools.profile_serve import add_config_options, config_of
from nlspn_eccv20_tpu_torch.tools.profile_serve import group_of as serve_group
from nlspn_eccv20_tpu_torch.train import Engine
from nlspn_eccv20_tpu_torch.utils.weights import randomize_

# kernel-name fragments of the backward kernels: K1b, K6b, K8's two passes,
# then K4's and K5's passes (bwd_common.cuh's two are shared by K4 and K5)
BWD_KERNELS = {"prop_step_bwd_kernel": "K1b prop_step_bwd",
               "prop_loop_bwd_kernel": "K6b prop_loop_bwd",
               "deform_bwd_read_kernel": "K8 deform_prop_bwd (d_off, d_aff)",
               "deform_bwd_feat_kernel": "K8 deform_prop_bwd (d_feat)",
               "dy1_kernel": "K4 decode_aff_tail_bwd", "dx_kernel": "K4 decode_aff_tail_bwd",
               "dp0_kernel": "K5 dep_encode_front_bwd", "dx0_kernel": "K5 dep_encode_front_bwd",
               "wgrad_s2_kernel": "K4/K5 weight gradients (bwd_common)",
               "reduce_chunks_kernel": "K4/K5 weight gradients (bwd_common)"}
WARMUP, TIMED, ITERS = 3, 11, 3   # steps: warm-up, CUDA-event timed, profiled


def group_of(name: str) -> str:
    for frag, group in BWD_KERNELS.items():
        if frag in name:
            return group
    low = name.lower()
    if "adam" in low or "multi_tensor" in low or "foreach" in low:
        return "optimizer (Adam)"
    return serve_group(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default="build")
    add_config_options(ap)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_of(args)
    eng = Engine(cfg, steps_per_epoch=100)      # the CUDA card or raise
    randomize_(eng.model, torch.Generator().manual_seed(4))
    eng.init_state()
    data = Synthetic(cfg, "train")
    rng = np.random.default_rng(5)
    b = cfg.batch_size
    batches = [eng.put_batch(data.batch([(i * b + j) % len(data) for j in range(b)], rng))
               for i in range(4)]

    for i in range(WARMUP):
        eng.train_step(batches[i % 4])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.train_step(batches[i % 4])
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(ITERS):
            eng.train_step(batches[i % 4])
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end) / ITERS

    busy, count, by_name = defaultdict(float), defaultdict(int), defaultdict(float)
    for a in prof.key_averages():
        if a.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(a, "self_device_time_total", 0.0) or a.self_cuda_time_total
        busy[group_of(a.key)] += us
        count[group_of(a.key)] += a.count
        by_name[a.key] += us
    busy_ms = sum(busy.values()) / 1e3 / ITERS
    report = {
        "device": torch.cuda.get_device_name(0),
        "offset": cfg.offset, "loop": args.loop, "batch": b,
        "patch": [cfg.patch_height, cfg.patch_width],
        "step_ms_median": sorted(step_ms)[TIMED // 2],
        "step_ms_min": min(step_ms),
        "peak_memory_gib": peak / 2**30,
        "profiled_window_ms_per_step": window_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "kernel_launches_per_step": sum(count.values()) / ITERS,
        "groups_ms_per_step": {g: v / 1e3 / ITERS for g, v in
                               sorted(busy.items(), key=lambda kv: -kv[1])},
        "group_launches_per_step": {g: n / ITERS for g, n in count.items()},
        "top_kernels_ms_per_step": [
            (n[:90], v / 1e3 / ITERS) for n, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:15]],
    }
    print(json.dumps(report, indent=1), flush=True)
    os.makedirs(args.trace_dir, exist_ok=True)
    name = f"trace_train{'_offset' if args.offset else '_loop' if args.loop else ''}_b12.json"
    prof.export_chrome_trace(os.path.join(args.trace_dir, name))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
