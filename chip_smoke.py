#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
hold every hand-written kernel against its plain PyTorch version there.

Run from the repository root, with one card:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card: its name and power limit as nvidia-smi gives them;
  2. build every kernel of ``nlspn_eccv20_tpu_torch/csrc`` (one nvcc per
     source, all at once) into ``build/``;
  3. each forward kernel against its plain version on the card, at the
     serving path's shapes for B=1 and B=4 (NYU 228x304 requests, bucketed
     to 256x320); with each kernel's time, its plain version's time, one
     PyTorch library call's time where one computes the same function, and
     the least time the card could take (its bound). K7 (deform_prop) also
     at the train step's B=12 of 228x304 with offsets clamped to the
     window, and 5x5; at serving shapes its offsets reach past the window
     (eval has none); its library call is F.grid_sample over all K2
     sampling grids stacked, then the affinity-weighted sum;
  4. each backward kernel the same way, at the train step's shapes (B=12
     and B=1, 228x304 patches), and run twice to show equal bits; the
     library time is cuDNN's backward of the same two convs
     (aten.convolution_backward, what autograd runs for them), and for K8
     (deform_prop_bwd) aten.grid_sampler_2d_backward and the elementwise
     rest; K8 also on offsets at their ties (zero, integers, +-R);
  5. serving: a Predictor on the default Config, every parameter random
     from a seeded generator, answers 4 single requests and one batch of 4;
     the launch counters are set to 0 just before and read just after; the
     whole forward through the kernels is held against the same forward
     with the plain versions;
  6. the same serving run on Config(offset=True), the non-local
     propagation (deform_prop 12, decode_aff_tail and dep_encode_front 11,
     prop_step 0 launches a forward);
  7. training: an Engine on the default Config (batch 12, 228x304 synthetic
     patches, Adam), every parameter random from a seeded generator, takes
     5 steps with the counters set to 0 just before and read just after
     (forward 12/11/11 and backward 12/11/11 launches a step); every
     parameter gets a finite gradient; one step's loss and gradients
     through the kernels are held against the same step with the plain
     versions; then the median step time and the peak memory;
  8. the same training run on Config(offset=True) (deform_prop and
     deform_prop_bwd 12 a step, the other four kernels 11, prop_step and
     prop_step_bwd 0);
  9. the kernel line, then {"ok": true, "device": ...} as the last line.

TF32 is off for cuDNN and for matmuls: every number here is float32. cuDNN
runs in benchmark mode (it times its algorithms per conv shape), as the
serving and training paths do.
Tolerances: relative error = max |kernel - plain| / max |plain|;
prop_step, prop_step_bwd, deform_prop and deform_prop_bwd <= 1e-5 (the
forwards: same operations in the same order, equal bits expected; the
backwards: sums of at most 9, or (2R+2)^2 = 100, products a neighbour in
another order), decode_aff_tail(_bwd) and dep_encode_front(_bwd) <= 1e-4
(f32 sums of up to 2,304 products, or a whole batch's pixels, in another
order), whole forward <= 2e-4 (PARITY.md's forward bar), whole train step:
loss <= 1e-4 and each parameter's gradient ||kernels - plain|| / ||plain||
<= 5e-3 (PARITY.md's gradient bar).
The kernel line's launches are each kernel's count on its path: the
default serving run's for the forward kernels, the default training run's
for the backward ones, the offset runs' for deform_prop and deform_prop_bwd.
"""

import json
import subprocess
import sys
import time

# Peak rates of the card (NVIDIA data sheets, dense, no sparsity), by part:
# float32 outside the tensor cores and HBM bandwidth.
PEAKS = {"SXM": {"f32_tflops": 67.0, "hbm_tbps": 3.35},
         "PCIe": {"f32_tflops": 51.0, "hbm_tbps": 2.0}}

H, W = 256, 320            # NYU 228x304 requests in the 32-pixel bucket
REQ_H, REQ_W = 228, 304
TRAIN_B = 12               # Config() defaults: batch 12 of 228x304 patches
TRAIN_STEPS, TIMED_STEPS = 5, 10
RADIUS = 4                 # Config().offset_window


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    import nlspn_eccv20_tpu_torch.models.nlspn as nlspn_mod
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic
    from nlspn_eccv20_tpu_torch.ops.affinity import normalize_affinity_planar
    from nlspn_eccv20_tpu_torch.ops.kernels import build
    from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
        decode_aff_tail, decode_aff_tail_bwd, decode_aff_tail_bwd_plain,
        decode_aff_tail_fwd_y1, decode_aff_tail_plain)
    from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import (
        deform_prop, deform_prop_bwd, deform_prop_bwd_plain,
        deform_prop_fwd_plain, deform_prop_plain)
    from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
        dep_encode_front, dep_encode_front_bwd, dep_encode_front_bwd_plain,
        dep_encode_front_plain)
    from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
        prop_step, prop_step_bwd, prop_step_bwd_plain, prop_step_plain)
    from nlspn_eccv20_tpu_torch.ops.propagate import (clamp_offsets,
                                                       neighbor_shifts)
    from nlspn_eccv20_tpu_torch.serve import Predictor
    from nlspn_eccv20_tpu_torch.train import Engine
    from nlspn_eccv20_tpu_torch.utils.weights import randomize_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the cuDNN setting the serving path runs under (Predictor.predict_batch),
    # so that plain and library times are held against the same cuDNN
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. the card ----
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak = PEAKS["PCIe" if "PCIe" in name else "SXM"]
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"TF32 off (cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False); "
        f"cudnn.benchmark=True; "
        f"peaks used for bounds: {peak}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(build.kernel_names())} kernels, "
        f"{time.perf_counter() - t0:.1f} s (built: {sorted(reports)})")
    for kname, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {kname}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev)

    def rand(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(dev)

    def sparse_depth(b, h, w, frac):
        keep = torch.rand((b, h, w), generator=gen) < frac
        return (keep * (0.5 + 9.5 * torch.rand((b, h, w), generator=gen))).to(dev)

    def time_ms(fn, reps=20, rounds=5):
        """Device time of one call: CUDA-graph replay of `reps` back-to-back
        calls between two CUDA events (no host launch cost), median of
        `rounds`, after a warm-up."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        times = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return sorted(times)[rounds // 2]

    def rel_err(out, ref):
        err = (out - ref).abs().max().item()
        return err, err / max(ref.abs().max().item(), 1e-30)

    def bound(nbytes, flops):
        t_bytes = nbytes / (peak["hbm_tbps"] * 1e12) * 1e3
        t_ops = flops / (peak["f32_tflops"] * 1e12) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def taps_t2(n):   # (output, tap) pairs of a k3/s2/p1/op1 transposed conv
        return 3 * n - 1

    def taps_s2(n):   # (output, tap) pairs of a k3/s2/p1 conv over n inputs
        n1 = (n + 1) // 2
        return 3 * n1 - 1 - (n % 2)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def deform_inputs(b, h, w, kernel, off_std):
        """pred, offsets ~ N(0, off_std^2), TGASS-normalised affinities,
        conf and NYU-density sparse depth for one deformable step."""
        k2 = kernel * kernel
        aff = normalize_affinity_planar(randn(b, k2 - 1, h, w),
                                        torch.full((1,), 0.5 * (k2 - 1), device=dev))
        return (rand(b, h, w, hi=10.0), randn(b, 2 * k2, h, w, std=off_std),
                aff.contiguous(), rand(b, h, w),
                sparse_depth(b, h, w, 500 / (REQ_H * REQ_W)))

    shifts = {k: torch.tensor(neighbor_shifts(k), device=dev, dtype=torch.float32)
              for k in (3, 5)}   # made here: no host copy in a captured graph

    def sampling_grid(off, kernel):
        """(B, 2 K2, H, W) offsets -> the (B, K2 H, W, 2) grid of
        F.grid_sample (align_corners=True) for all K2 neighbours."""
        b, _, h, w = off.shape
        k2 = kernel * kernel
        sh = shifts[kernel]
        sy = (torch.arange(h, device=dev, dtype=off.dtype).view(1, 1, h, 1)
              + sh[:, 0].view(1, k2, 1, 1) + off[:, 0::2])
        sx = (torch.arange(w, device=dev, dtype=off.dtype).view(1, 1, 1, w)
              + sh[:, 1].view(1, k2, 1, 1) + off[:, 1::2])
        grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0, sy * (2.0 / (h - 1)) - 1.0], -1)
        return grid.view(b, k2 * h, w, 2)

    def deform_library(pred, off, aff, conf, dep, kernel):
        """K7's function through F.grid_sample (zeros outside) over the
        stacked grids, the affinity-weighted sum and the blend."""
        b, h, w = pred.shape
        smp = F.grid_sample((pred * conf)[:, None], sampling_grid(off, kernel),
                            mode="bilinear", padding_mode="zeros", align_corners=True)
        acc = (smp.view(b, -1, h, w) * aff).sum(1)
        m = (dep > 0).float()
        return (1.0 - m) * acc + m * dep

    def deform_flops(b, h, w, k2):
        # a neighbour: 4 taps x (conf, weight, product, sum) and 8 for the
        # fractions and weights, 2 for the affinity; the blend
        return b * h * w * (26 * k2 + 5)

    # ---- 3. each forward kernel against its plain version ----
    rows = {}

    def record(kname, b, err, rel, tol, ms, plain_ms, lib_ms, bnd, main_b=1):
        """Log one kernel's check and times; the kernel line keeps those
        at batch ``main_b`` (the serving path's 1, the train step's 12)."""
        if not rel <= tol:
            raise AssertionError(
                f"{kname} B={b}: relative error {rel:.3e} > {tol:.0e}")
        r = rows.setdefault(kname, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log(f"[kernel] {kname} B={b}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {tol:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        if b == main_b:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bnd[0], bound_by=bnd[1])

    for b in (1, 4):
        # K1: the fork default's step (3x3, conf, preserve, no clip)
        for kernel in (3, 5) if b == 1 else (3,):
            k2 = kernel * kernel
            pred = rand(b, H, W, hi=10.0)
            aff = normalize_affinity_planar(randn(b, k2 - 1, H, W),
                                            torch.full((1,), 0.5 * (k2 - 1), device=dev))
            aff = aff.contiguous()
            conf, dep = rand(b, H, W), sparse_depth(b, H, W, 500 / (REQ_H * REQ_W))
            kw = dict(kernel=kernel, preserve=True, clip=False)
            out = prop_step(pred, aff, conf, dep, **kw)
            ref = prop_step_plain(pred, aff, conf, dep, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            if kernel == 3:
                bnd = bound(nbytes(pred, aff, conf, dep, out),
                            b * H * W * (2 * k2 + 5))
                record("prop_step", b, err, rel, 1e-5,
                       time_ms(lambda: prop_step(pred, aff, conf, dep, **kw)),
                       time_ms(lambda: prop_step_plain(pred, aff, conf, dep, **kw)),
                       None, bnd)
            elif not rel <= 1e-5:
                raise AssertionError(f"prop_step 5x5: relative error {rel:.3e}")
            else:
                log(f"[kernel] prop_step 5x5 B={b}: rel {rel:.3e}")

        # K2: decode_aff tail, base grid 64x80, 256 -> 16 -> K
        hg, wg = H // 4, W // 4
        for k in (8, 24) if b == 1 else (8,):
            x = randn(b, hg, wg, 256).relu()
            w1, b1 = randn(256, 16, 3, 3, std=(256 * 9 / 4) ** -0.5), randn(16, std=0.1)
            w2, b2 = randn(16, k, 3, 3, std=(16 * 9 / 4) ** -0.5), randn(k, std=0.1)
            out = decode_aff_tail(x, w1, b1, w2, b2)
            ref = decode_aff_tail_plain(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            if k != 8:
                if not rel <= 1e-4:
                    raise AssertionError(f"decode_aff_tail K={k}: rel {rel:.3e}")
                log(f"[kernel] decode_aff_tail K={k} B={b}: rel {rel:.3e}")
                continue
            xn = x.permute(0, 3, 1, 2).contiguous()

            def library():
                y = F.relu(F.conv_transpose2d(xn, w1, b1, 2, 1, 1))
                return F.conv_transpose2d(y, w2, b2, 2, 1, 1)

            flops = 2 * b * (taps_t2(hg) * taps_t2(wg) * 256 * 16
                             + taps_t2(2 * hg) * taps_t2(2 * wg) * 16 * k)
            record("decode_aff_tail", b, err, rel, 1e-4,
                   time_ms(lambda: decode_aff_tail(x, w1, b1, w2, b2)),
                   time_ms(lambda: decode_aff_tail_plain(x, w1, b1, w2, b2)),
                   time_ms(library),
                   bound(nbytes(x, w1, b1, w2, b2, out), flops))

        # K3: encode_dep front, 256x320 plane -> 64x80x256
        plane = rand(b, H, W)
        w0, b0 = randn(16, 1, 3, 3, std=1 / 3), randn(16, std=0.1)
        w1, b1 = randn(256, 16, 3, 3, std=1 / 12), randn(256, std=0.1)
        out = dep_encode_front(plane, w0, b0, w1, b1)
        ref = dep_encode_front_plain(plane, w0, b0, w1, b1)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        p4 = plane[:, None]

        def library():
            return F.relu(F.conv2d(F.relu(F.conv2d(p4, w0, b0, 2, 1)), w1, b1, 2, 1))

        flops = 2 * b * (taps_s2(H) * taps_s2(W) * 16
                         + taps_s2((H + 1) // 2) * taps_s2((W + 1) // 2) * 16 * 256)
        record("dep_encode_front", b, err, rel, 1e-4,
               time_ms(lambda: dep_encode_front(plane, w0, b0, w1, b1)),
               time_ms(lambda: dep_encode_front_plain(plane, w0, b0, w1, b1)),
               time_ms(library), bound(nbytes(plane, w0, b0, w1, b1, out), flops))

        # an odd shape the TPU kernel refused: the CUDA kernel takes it
        if b == 1:
            plane_odd = rand(1, 230, 306)
            err, rel = rel_err(dep_encode_front(plane_odd, w0, b0, w1, b1),
                               dep_encode_front_plain(plane_odd, w0, b0, w1, b1))
            if not rel <= 1e-4:
                raise AssertionError(f"dep_encode_front 230x306: rel {rel:.3e}")
            log(f"[kernel] dep_encode_front 230x306: rel {rel:.3e}")

        # K7: the offset step as served (eval: offsets also past the window)
        for kernel in (3, 5) if b == 1 else (3,):
            pred, off, aff, conf, dep = deform_inputs(b, H, W, kernel, 1.5)
            kw = dict(kernel=kernel, preserve=True, clip=False)
            out = deform_prop(pred, off, aff, conf, dep, **kw)
            ref = deform_prop_fwd_plain(pred, off, aff, conf, dep, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            if kernel == 5:
                if not rel <= 1e-5:
                    raise AssertionError(f"deform_prop 5x5: relative error {rel:.3e}")
                log(f"[kernel] deform_prop 5x5 B={b}: rel {rel:.3e}")
                continue
            _, lib_rel = rel_err(deform_library(pred, off, aff, conf, dep, 3), ref)
            if not lib_rel <= 1e-3:
                raise AssertionError(f"grid_sample yardstick: rel {lib_rel:.3e}")
            log(f"[kernel] deform_prop B={b}: max|offset| {off.abs().max().item():.2f}, "
                f"{(off.abs() > RADIUS).float().mean().item():.2e} of them past "
                f"{RADIUS}; grid_sample yardstick rel {lib_rel:.1e}")
            record("deform_prop", b, err, rel, 1e-5,
                   time_ms(lambda: deform_prop(pred, off, aff, conf, dep, **kw)),
                   time_ms(lambda: deform_prop_fwd_plain(pred, off, aff, conf, dep, **kw)),
                   time_ms(lambda: deform_library(pred, off, aff, conf, dep, 3)),
                   bound(nbytes(pred, off, aff, conf, dep, out),
                         deform_flops(b, H, W, 9)))

    # K7 at the train step's shape, offsets clamped to the window
    pred, off, aff, conf, dep = deform_inputs(TRAIN_B, REQ_H, REQ_W, 3, 1.5)
    off = clamp_offsets(off, RADIUS).contiguous()
    kw = dict(kernel=3, preserve=True, clip=False)
    out = deform_prop(pred, off, aff, conf, dep, **kw)
    ref = deform_prop_fwd_plain(pred, off, aff, conf, dep, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    record("deform_prop", TRAIN_B, err, rel, 1e-5,
           time_ms(lambda: deform_prop(pred, off, aff, conf, dep, **kw)),
           time_ms(lambda: deform_prop_fwd_plain(pred, off, aff, conf, dep, **kw)),
           time_ms(lambda: deform_library(pred, off, aff, conf, dep, 3)),
           bound(nbytes(pred, off, aff, conf, dep, out),
                 deform_flops(TRAIN_B, REQ_H, REQ_W, 9)))

    # ---- 4. each backward kernel against its plain version ----
    conv_bwd = torch.ops.aten.convolution_backward
    grid_bwd = torch.ops.aten.grid_sampler_2d_backward

    def grads_err(got, want):
        """max_abs_err and relative error over all of a kernel's outputs."""
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        return max(e for e, _ in errs), max(r for _, r in errs)

    def same_bits(fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)

    def check_bwd(kname, b, fn, plain, tol, lib, bnd, plain_reps=20):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err, rel = grads_err(got, want)
        if not same_bits(fn):
            raise AssertionError(f"{kname} B={b}: two runs gave other bits")
        record(kname, b, err, rel, tol, time_ms(fn), time_ms(plain, reps=plain_reps),
               None if lib is None else time_ms(lib), bnd, main_b=TRAIN_B)
        log(f"[kernel] {kname} B={b}: two runs, equal bits")

    for b in (TRAIN_B, 1):
        # K1b: the fork default's step (3x3, conf, preserve, no clip)
        pred = rand(b, REQ_H, REQ_W, hi=10.0)
        aff = normalize_affinity_planar(randn(b, 8, REQ_H, REQ_W),
                                        torch.full((1,), 4.0, device=dev))
        aff = aff.contiguous()
        conf = rand(b, REQ_H, REQ_W)
        dep = sparse_depth(b, REQ_H, REQ_W, 500 / (REQ_H * REQ_W))
        g = randn(b, REQ_H, REQ_W)
        kw = dict(kernel=3, preserve=True, clip=False)
        outs = prop_step_bwd(g, pred, aff, conf, dep, **kw)
        check_bwd("prop_step_bwd", b,
                  lambda: prop_step_bwd(g, pred, aff, conf, dep, **kw),
                  lambda: prop_step_bwd_plain(g, pred, aff, conf, dep, **kw),
                  1e-5, None,
                  bound(nbytes(g, pred, aff, conf, dep, *outs),
                        b * REQ_H * REQ_W * (3 * 9 + 4)))
        if b == 1:  # the clip's ties (an all-zero corner) and the 5x5 kernel
            pred[:, :64, :64] = 0.0
            for kernel in (3, 5):
                a = normalize_affinity_planar(
                    randn(b, kernel * kernel - 1, REQ_H, REQ_W),
                    torch.full((1,), 0.5 * (kernel * kernel - 1), device=dev))
                a = a.contiguous()
                kwc = dict(kernel=kernel, preserve=True, clip=True)
                _, rel = grads_err(prop_step_bwd(g, pred, a, conf, dep, **kwc),
                                   prop_step_bwd_plain(g, pred, a, conf, dep, **kwc))
                if not rel <= 1e-5:
                    raise AssertionError(f"prop_step_bwd {kernel}x{kernel} clip: "
                                         f"rel {rel:.3e}")
                log(f"[kernel] prop_step_bwd {kernel}x{kernel} clip B={b}: rel {rel:.3e}")

        # K4: decode_aff tail at the train step's base grid 58x76 (232x304
        # out, trimmed to 228 rows: the trimmed rows' cotangent is zero)
        hg, wg = 58, 76
        x = randn(b, hg, wg, 256).relu()
        w1, b1 = randn(256, 16, 3, 3, std=(256 * 9 / 4) ** -0.5), randn(16, std=0.1)
        w2, b2 = randn(16, 8, 3, 3, std=(16 * 9 / 4) ** -0.5), randn(8, std=0.1)
        _, y1 = decode_aff_tail_fwd_y1(x, w1, b1, w2, b2)
        g = randn(b, 8, 4 * hg, 4 * wg)
        g[:, :, REQ_H:] = 0.0
        outs = decode_aff_tail_bwd(g, x, w1, w2, y1)
        xn = x.permute(0, 3, 1, 2).contiguous()

        def library():
            d_y1, d_w2, d_b2 = conv_bwd(g, y1, w2, [8], [2, 2], [1, 1], [1, 1],
                                        True, [1, 1], 1, [True, True, True])
            d_y1 = torch.ops.aten.threshold_backward(d_y1, y1, 0.0)
            return conv_bwd(d_y1, xn, w1, [16], [2, 2], [1, 1], [1, 1], True,
                            [1, 1], 1, [True, True, True]) + (d_w2, d_b2)

        flops = 2 * 2 * b * (taps_t2(hg) * taps_t2(wg) * 256 * 16
                             + taps_t2(2 * hg) * taps_t2(2 * wg) * 16 * 8)
        check_bwd("decode_aff_tail_bwd", b,
                  lambda: decode_aff_tail_bwd(g, x, w1, w2, y1),
                  lambda: decode_aff_tail_bwd_plain(g, x, w1, w2, y1),
                  1e-4, library,
                  bound(nbytes(g, x, w1, w2, y1, *outs), flops))

        # K5: encode_dep front, 228x304 plane -> 57x76x256. The plane and
        # conv0's weights are multiples of 1/64, so that conv0's sums are
        # exact in any order: K5 recomputes conv0 as K3 does, its plain
        # version through cuDNN, and both then take the same ReLU mask.
        def sixty_fourths(*shape, lo, hi):
            return (torch.randint(lo, hi + 1, shape, generator=gen) / 64).to(dev)

        plane = sixty_fourths(b, REQ_H, REQ_W, lo=0, hi=64)
        w0, b0 = sixty_fourths(16, 1, 3, 3, lo=-21, hi=21), sixty_fourths(16, lo=-6, hi=6)
        w1, b1 = randn(256, 16, 3, 3, std=1 / 12), randn(256, std=0.1)
        out = dep_encode_front(plane, w0, b0, w1, b1)
        g = randn(*out.shape)
        outs = dep_encode_front_bwd(g, plane, w0, b0, w1, out)
        p4 = plane[:, None]
        p0 = F.relu(F.conv2d(p4, w0, b0, 2, 1))
        out_n = out.permute(0, 3, 1, 2).contiguous()
        g_n = g.permute(0, 3, 1, 2).contiguous()

        def library():
            gm = torch.ops.aten.threshold_backward(g_n, out_n, 0.0)
            d_p0, d_w1, d_b1 = conv_bwd(gm, p0, w1, [256], [2, 2], [1, 1], [1, 1],
                                        False, [0, 0], 1, [True, True, True])
            d_p0 = torch.ops.aten.threshold_backward(d_p0, p0, 0.0)
            return conv_bwd(d_p0, p4, w0, [16], [2, 2], [1, 1], [1, 1], False,
                            [0, 0], 1, [True, True, True]) + (d_w1, d_b1)

        conv0_pairs = taps_s2(REQ_H) * taps_s2(REQ_W) * 16
        conv1_pairs = (taps_s2((REQ_H + 1) // 2) * taps_s2((REQ_W + 1) // 2)
                       * 16 * 256)
        # dx, dW0 and the recomputed conv0; dP0 and dW1
        flops = 2 * b * (3 * conv0_pairs + 2 * conv1_pairs)
        check_bwd("dep_encode_front_bwd", b,
                  lambda: dep_encode_front_bwd(g, plane, w0, b0, w1, out),
                  lambda: dep_encode_front_bwd_plain(g, plane, w0, b0, w1, out),
                  1e-4, library,
                  bound(nbytes(g, plane, w0, b0, w1, out, *outs), flops))

        # K8: the offset step's backward, offsets clamped to the window
        pred, off, aff, conf, dep = deform_inputs(b, REQ_H, REQ_W, 3, 1.5)
        off = clamp_offsets(off, RADIUS).contiguous()
        g = randn(b, REQ_H, REQ_W)
        kw = dict(kernel=3, radius=RADIUS, preserve=True, clip=False)
        outs = deform_prop_bwd(g, pred, off, aff, conf, dep, **kw)
        feat4, grid = (pred * conf)[:, None], sampling_grid(off, 3)
        smp = F.grid_sample(feat4, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True).view(b, 9, REQ_H, REQ_W)

        def library():
            """autograd's backward of deform_library, written out: the
            sampler's backward, then the elementwise rest."""
            ga = g * (1.0 - (dep > 0).float())
            d_feat, d_grid = grid_bwd((ga[:, None] * aff).view(b, 1, -1, REQ_W), feat4,
                                      grid, 0, 0, True, [True, True])
            d_grid = d_grid.view(b, 9, REQ_H, REQ_W, 2)
            d_off = torch.stack([d_grid[..., 1] * (2.0 / (REQ_H - 1)),
                                 d_grid[..., 0] * (2.0 / (REQ_W - 1))], 2)
            d_feat = d_feat[:, 0]
            return (d_feat * conf, d_off.view(b, 18, REQ_H, REQ_W),
                    ga[:, None] * smp, d_feat * pred)

        # per pixel and neighbour: up to 3x3 taps of value and two slopes,
        # and the four corners' scatter
        check_bwd("deform_prop_bwd", b,
                  lambda: deform_prop_bwd(g, pred, off, aff, conf, dep, **kw),
                  lambda: deform_prop_bwd_plain(g, pred, off, aff, conf, dep, **kw),
                  1e-5, library,
                  bound(nbytes(g, pred, off, aff, conf, dep, *outs),
                        b * REQ_H * REQ_W * (9 * 60 + 10)), plain_reps=2)
        if b == 1:  # the ties: zero, integer and +-R offsets, integers moved
            # by an ulp or two (where rounding makes |oy - u| exactly 1), and
            # the clip's zeros
            ties = torch.randint(-RADIUS - 1, RADIUS + 2, off.shape, generator=gen).float()
            ties[:, :, :REQ_H // 3] = 0
            band = ties[:, :, REQ_H // 3:REQ_H // 2]
            band += (torch.rand(band.shape, generator=gen) - 0.5) * 5e-7
            off_t = clamp_offsets(ties.to(dev), RADIUS).contiguous()
            pred[:, :64, :64] = 0.0
            for clip in (False, True):
                kwt = dict(kw, clip=clip)
                fn = lambda: deform_prop_bwd(g, pred, off_t, aff, conf, dep, **kwt)
                _, rel = grads_err(fn(), deform_prop_bwd_plain(g, pred, off_t, aff,
                                                               conf, dep, **kwt))
                if not rel <= 1e-5 or not same_bits(fn):
                    raise AssertionError(f"deform_prop_bwd ties clip={clip}: "
                                         f"rel {rel:.3e} or other bits")
                log(f"[kernel] deform_prop_bwd ties clip={clip} B={b}: rel {rel:.3e}, "
                    f"equal bits in two runs")

    # ---- 5. and 6. serving ----
    fwd_wrappers = {"prop_step": prop_step, "deform_prop": deform_prop,
                    "decode_aff_tail": decode_aff_tail,
                    "dep_encode_front": dep_encode_front}
    bwd_wrappers = {"prop_step_bwd": prop_step_bwd,
                    "deform_prop_bwd": deform_prop_bwd,
                    "decode_aff_tail_bwd": decode_aff_tail_bwd,
                    "dep_encode_front_bwd": dep_encode_front_bwd}
    plain_of = {"prop_step": prop_step_plain, "deform_prop": deform_prop_plain,
                "decode_aff_tail": decode_aff_tail_plain,
                "dep_encode_front": dep_encode_front_plain}

    def expected_launches(cfg, wrappers):
        """Launches a forward (and a backward) of ``cfg`` makes: the step
        kernel of its propagation prop_time times, the GRU's two
        prop_time - 1 times, the other step kernel never."""
        step = "deform_prop" if cfg.offset else "prop_step"
        return {k: (cfg.prop_time if k in (step, step + "_bwd")
                    else 0 if k.startswith(("prop_step", "deform_prop"))
                    else cfg.prop_time - 1) for k in wrappers}

    def with_plain_versions(fn):
        """fn() with the model calling every kernel's plain version."""
        saved = {k: getattr(nlspn_mod, k) for k in plain_of}
        try:
            for k, f in plain_of.items():
                setattr(nlspn_mod, k, f)
            return fn()
        finally:
            for k, f in saved.items():
                setattr(nlspn_mod, k, f)

    def serve(cfg, tag):
        """4 single requests and one batch of 4 through a Predictor with
        random weights; launch counts, outputs, the whole forward against
        the plain versions, latency and forward time. Returns the counts."""
        predictor = Predictor(cfg, device=dev)
        randomize_(predictor.model, torch.Generator().manual_seed(1))
        rng = np.random.default_rng(2)

        def request():
            rgb = rng.integers(0, 256, (REQ_H, REQ_W, 3), dtype=np.uint8)
            dep = np.zeros((REQ_H, REQ_W), np.float32)
            idx = rng.choice(REQ_H * REQ_W, cfg.num_sample, replace=False)
            dep.flat[idx] = rng.uniform(0.5, 10.0, cfg.num_sample)
            return rgb, dep

        per_forward = expected_launches(cfg, fwd_wrappers)
        batches = [[request()] for _ in range(4)] + [[request() for _ in range(4)]]

        for fn in fwd_wrappers.values():
            fn.launches = 0
        counts_before = {k: 0 for k in fwd_wrappers}
        for reqs in batches:
            outs = predictor.predict_batch([r for r, _ in reqs], [d for _, d in reqs])
            for (_, dep), out in zip(reqs, outs):
                if out.shape != (REQ_H, REQ_W) or not np.isfinite(out).all():
                    raise AssertionError(f"bad output {out.shape}, finite="
                                         f"{np.isfinite(out).all()}")
                m = dep > 0
                if not np.array_equal(out[m], dep[m]):
                    raise AssertionError("preserve_input: observed depth not kept")
            for k, fn in fwd_wrappers.items():
                if fn.launches - counts_before[k] != per_forward[k]:
                    raise AssertionError(
                        f"{tag}: {k}: {fn.launches - counts_before[k]} launches "
                        f"in one forward, expected {per_forward[k]}")
                counts_before[k] = fn.launches
        launches = {k: fn.launches for k, fn in fwd_wrappers.items()}
        log(f"[serve{tag}] {len(batches)} forwards (4 x b=1, 1 x b=4) of "
            f"{REQ_H}x{REQ_W}: outputs finite, observed depth kept exactly; "
            f"launches {launches} = {per_forward} per forward")
        for k, n in launches.items():
            if per_forward[k] and n == 0:
                raise AssertionError(f"{k} was not launched on the serving path")

        # the whole forward through the kernels vs the same with plain versions
        sample, _ = predictor.make_sample([r for r, _ in batches[-1]],
                                          [d for _, d in batches[-1]])
        with torch.inference_mode():
            out_k = predictor.model(sample)
            out_p = with_plain_versions(lambda: predictor.model(sample))
        keys = ("pred", "aff", "pred_init") + (("offset",) if cfg.offset else ())
        for key in keys:
            err = (out_k[key] - out_p[key]).abs().max().item()
            rel = err / max(out_p[key].abs().max().item(), 1.0)
            log(f"[forward{tag}] {key}: kernels vs plain max_abs_err {err:.3e} "
                f"rel {rel:.3e}")
            if not rel <= 2e-4:
                raise AssertionError(f"whole forward {key}: rel {rel:.3e} > 2e-4")
        for i, (pk, pp) in enumerate(zip(out_k["pred_inter"], out_p["pred_inter"])):
            rel = (pk - pp).abs().max().item() / max(pp.abs().max().item(), 1.0)
            if not rel <= 2e-4:
                raise AssertionError(f"whole forward pred_inter[{i}]: rel {rel:.3e}")
        if cfg.offset:
            off = out_k["offset"]
            log(f"[forward{tag}] offsets: max |offset| {off.abs().max().item():.3f}, "
                f"{(off.abs() > cfg.offset_window).float().mean().item():.3e} "
                f"of them past the window {cfg.offset_window}")

        # latency
        for b in (1, 4):
            res = predictor.benchmark(REQ_H, REQ_W, batch=b, calls=20, seed=3)
            log(f"[serve{tag}] b={b} predict_batch latency (CUDA events, host "
                f"prep and copies included): median {res['median_s'] * 1e3:.3f} "
                f"ms, min {res['min_s'] * 1e3:.3f} ms")
        with torch.inference_mode():
            for b in (1, 4):
                s = {k: v[:b] for k, v in sample.items()}
                fwd = []
                for _ in range(11):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    predictor.model(s, need_inter=False)
                    end.record()
                    end.synchronize()
                    fwd.append(start.elapsed_time(end))
                log(f"[serve{tag}] b={b} model forward alone (CUDA events): "
                    f"median {sorted(fwd)[5]:.3f} ms")
        return launches

    launches = serve(Config(), "")
    offset_launches = serve(Config(offset=True), " offset")
    torch.cuda.empty_cache()

    # ---- 7. and 8. training ----
    def train(tcfg, tag):
        """5 Engine steps at batch 12 of 228x304 with random weights; launch
        counts, finite gradients, one step against the plain versions, step
        time, peak memory and an eval step. Returns the counts."""
        if (tcfg.batch_size, tcfg.patch_height, tcfg.patch_width) != (TRAIN_B, REQ_H, REQ_W):
            raise AssertionError("Config() no longer trains on 12 x 228x304")
        eng = Engine(tcfg, steps_per_epoch=100, device=dev)  # a 100-step warm-up
        randomize_(eng.model, torch.Generator().manual_seed(4))
        model = eng.init_state()
        data = Synthetic(tcfg, "train")
        drng = np.random.default_rng(5)
        n_batches = TRAIN_STEPS + TIMED_STEPS
        tbatches = [eng.put_batch(data.batch(
            [(i * TRAIN_B + j) % len(data) for j in range(TRAIN_B)], drng))
            for i in range(n_batches)]
        train_wrappers = {**fwd_wrappers, **bwd_wrappers}
        per_step = expected_launches(tcfg, train_wrappers)

        def count():
            return {k: fn.launches for k, fn in train_wrappers.items()}

        for fn in train_wrappers.values():
            fn.launches = 0
        before = count()
        losses = []
        for i in range(TRAIN_STEPS):
            aux = eng.train_step(tbatches[i])
            losses.append(aux["loss"].item())
            now = count()
            steps_launches = {k: now[k] - before[k] for k in now}
            if steps_launches != per_step:
                raise AssertionError(f"{tag}: train step {i}: launches "
                                     f"{steps_launches}, expected {per_step}")
            before = now
            if not np.isfinite(losses[-1]):
                raise AssertionError(f"train step {i}: loss {losses[-1]}")
            if i == 0:
                for pname, p in model.named_parameters():
                    if p.grad is None or not torch.isfinite(p.grad).all():
                        raise AssertionError(f"train step 0: {pname} has no "
                                             f"finite gradient")
        train_launches = count()
        extra = (f"; max |offset| {aux['off_max'].item():.3f} after step "
                 f"{TRAIN_STEPS}" if tcfg.offset else "")
        log(f"[train{tag}] {TRAIN_STEPS} steps of {TRAIN_B} x {REQ_H}x{REQ_W}: "
            f"losses {[round(v, 4) for v in losses]}, finite; every parameter "
            f"got a finite gradient; launches {train_launches} = {per_step} per "
            f"step{extra}")
        for k, n in train_launches.items():
            if per_step[k] and n == 0:
                raise AssertionError(f"{k} was not launched on the training path")

        # one step's loss and gradients through the kernels vs the plain versions
        batch = tbatches[0]

        def loss_and_grads():
            model.zero_grad(set_to_none=True)
            out = model(batch, need_inter=False)
            loss = eng.loss_fn(batch, out)[0] / TRAIN_B
            loss.backward()
            return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

        loss_k, grads_k = loss_and_grads()
        loss_p, grads_p = with_plain_versions(loss_and_grads)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        worst = max(((grads_k[n] - grads_p[n]).norm().item()
                     / max(grads_p[n].norm().item(), 1e-30), n) for n in grads_p)
        log(f"[train{tag}] one step, kernels vs plain: loss {loss_k:.6f} vs "
            f"{loss_p:.6f} (rel {rel:.3e}); worst gradient {worst[1]} rel "
            f"{worst[0]:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"train step loss: rel {rel:.3e} > 1e-4")
        if not worst[0] <= 5e-3:
            raise AssertionError(f"train step gradient {worst[1]}: rel {worst[0]:.3e}")
        del grads_k, grads_p

        # step time and peak memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for i in range(TRAIN_STEPS, n_batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            aux = eng.train_step(tbatches[i])
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            if not np.isfinite(aux["loss"].item()):
                raise AssertionError(f"timed train step: loss {aux['loss'].item()}")
        peak = torch.cuda.max_memory_allocated()
        log(f"[train{tag}] b={TRAIN_B} train step (CUDA events, forward + loss + "
            f"backward + Adam): median {sorted(step_ms)[len(step_ms) // 2]:.3f} "
            f"ms, min {min(step_ms):.3f} ms over {len(step_ms)} steps; peak "
            f"memory {peak / 2**30:.3f} GiB")
        ev = eng.eval_step(tbatches[0])
        if ev["loss_val"].shape != (TRAIN_B, 3) or ev["metric"].shape != (TRAIN_B, 8) \
                or not torch.isfinite(ev["loss_val"]).all():
            raise AssertionError("eval step: bad rows")
        log(f"[train{tag}] eval step: per-image loss {tuple(ev['loss_val'].shape)} "
            f"and metric {tuple(ev['metric'].shape)} rows, finite")
        return train_launches

    train_launches = train(Config(), "")
    torch.cuda.empty_cache()
    offset_train_launches = train(Config(offset=True), " offset")

    # ---- 9. results ----
    sources = {
        "prop_step": ("nlspn_eccv20_tpu_torch/csrc/prop_step.cu",
                      "nlspn_eccv20_tpu/ops/pallas/local_prop.py:77"),
        "decode_aff_tail": ("nlspn_eccv20_tpu_torch/csrc/dec_aff_tail.cu",
                            "nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py:284"),
        "dep_encode_front": ("nlspn_eccv20_tpu_torch/csrc/dep_encode_front.cu",
                             "nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py:251"),
        "prop_step_bwd": ("nlspn_eccv20_tpu_torch/csrc/prop_step_bwd.cu",
                          "nlspn_eccv20_tpu/ops/pallas/local_prop.py:148"),
        "decode_aff_tail_bwd": ("nlspn_eccv20_tpu_torch/csrc/dec_aff_tail_bwd.cu",
                                "nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py:476"),
        "dep_encode_front_bwd": ("nlspn_eccv20_tpu_torch/csrc/dep_encode_front_bwd.cu",
                                 "nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py:405"),
        "deform_prop": ("nlspn_eccv20_tpu_torch/csrc/deform_prop.cu",
                        "nlspn_eccv20_tpu/ops/pallas/deform_prop.py:171"),
        "deform_prop_bwd": ("nlspn_eccv20_tpu_torch/csrc/deform_prop_bwd.cu",
                            "nlspn_eccv20_tpu/ops/pallas/deform_prop.py:300"),
    }
    path_launches = {**launches, **{k: train_launches[k] for k in bwd_wrappers},
                     "deform_prop": offset_launches["deform_prop"],
                     "deform_prop_bwd": offset_train_launches["deform_prop_bwd"]}
    kernels = []
    for k, (src, replaces) in sources.items():
        r = rows[k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": path_launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
