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
     the least time the card could take (its bound);
  4. each backward kernel the same way, at the train step's shapes (B=12
     and B=1, 228x304 patches), and run twice to show equal bits; the
     library time is cuDNN's backward of the same two convs
     (aten.convolution_backward, what autograd runs for them);
  5. serving: a Predictor on the default Config, every parameter random
     from a seeded generator, answers 4 single requests and one batch of 4;
     the launch counters are set to 0 just before and read just after; the
     whole forward through the kernels is held against the same forward
     with the plain versions;
  6. training: an Engine on the default Config (batch 12, 228x304 synthetic
     patches, Adam), every parameter random from a seeded generator, takes
     5 steps with the counters set to 0 just before and read just after
     (forward 12/11/11 and backward 12/11/11 launches a step); every
     parameter gets a finite gradient; one step's loss and gradients
     through the kernels are held against the same step with the plain
     versions; then the median step time and the peak memory;
  7. the kernel line, then {"ok": true, "device": ...} as the last line.

TF32 is off for cuDNN and for matmuls: every number here is float32. cuDNN
runs in benchmark mode (it times its algorithms per conv shape), as the
serving and training paths do.
Tolerances: relative error = max |kernel - plain| / max |plain|;
prop_step and prop_step_bwd <= 1e-5 (the forward: same operations in the
same order, equal bits expected; the backward: sums of at most 9 products
in another order), decode_aff_tail(_bwd) and dep_encode_front(_bwd) <= 1e-4
(f32 sums of up to 2,304 products, or a whole batch's pixels, in another
order), whole forward <= 2e-4 (PARITY.md's forward bar), whole train step:
loss <= 1e-4 and each parameter's gradient ||kernels - plain|| / ||plain||
<= 5e-3 (PARITY.md's gradient bar).
The kernel line's launches are each kernel's count on its path: the serving
run's for the forward kernels, the training run's for the backward ones.
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
    from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
        dep_encode_front, dep_encode_front_bwd, dep_encode_front_bwd_plain,
        dep_encode_front_plain)
    from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
        prop_step, prop_step_bwd, prop_step_bwd_plain, prop_step_plain)
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

    # ---- 4. each backward kernel against its plain version ----
    conv_bwd = torch.ops.aten.convolution_backward

    def grads_err(got, want):
        """max_abs_err and relative error over all of a kernel's outputs."""
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        return max(e for e, _ in errs), max(r for _, r in errs)

    def same_bits(fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)

    def check_bwd(kname, b, fn, plain, tol, lib, bnd):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err, rel = grads_err(got, want)
        if not same_bits(fn):
            raise AssertionError(f"{kname} B={b}: two runs gave other bits")
        record(kname, b, err, rel, tol, time_ms(fn), time_ms(plain),
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

    # ---- 5. serving ----
    cfg = Config()
    predictor = Predictor(cfg, device=dev)
    randomize_(predictor.model, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)

    def request():
        rgb = rng.integers(0, 256, (REQ_H, REQ_W, 3), dtype=np.uint8)
        dep = np.zeros((REQ_H, REQ_W), np.float32)
        idx = rng.choice(REQ_H * REQ_W, cfg.num_sample, replace=False)
        dep.flat[idx] = rng.uniform(0.5, 10.0, cfg.num_sample)
        return rgb, dep

    wrappers = {"prop_step": prop_step, "decode_aff_tail": decode_aff_tail,
                "dep_encode_front": dep_encode_front}
    per_forward = {"prop_step": cfg.prop_time,
                   "decode_aff_tail": cfg.prop_time - 1,
                   "dep_encode_front": cfg.prop_time - 1}
    batches = [[request()] for _ in range(4)] + [[request() for _ in range(4)]]

    for fn in wrappers.values():
        fn.launches = 0
    counts_before = {k: 0 for k in wrappers}
    for reqs in batches:
        outs = predictor.predict_batch([r for r, _ in reqs], [d for _, d in reqs])
        for (_, dep), out in zip(reqs, outs):
            if out.shape != (REQ_H, REQ_W) or not np.isfinite(out).all():
                raise AssertionError(f"bad output {out.shape}, finite="
                                     f"{np.isfinite(out).all()}")
            m = dep > 0
            if not np.array_equal(out[m], dep[m]):
                raise AssertionError("preserve_input: observed depth not kept")
        for k, fn in wrappers.items():
            if fn.launches - counts_before[k] != per_forward[k]:
                raise AssertionError(
                    f"{k}: {fn.launches - counts_before[k]} launches in one "
                    f"forward, expected {per_forward[k]}")
            counts_before[k] = fn.launches
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log(f"[serve] {len(batches)} forwards (4 x b=1, 1 x b=4) of "
        f"{REQ_H}x{REQ_W}: outputs finite, observed depth kept exactly; "
        f"launches {launches} = {per_forward} per forward")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was not launched on the serving path")

    # the whole forward through the kernels vs the same with plain versions
    sample, _ = predictor.make_sample([r for r, _ in batches[-1]],
                                      [d for _, d in batches[-1]])
    with torch.inference_mode():
        out_k = predictor.model(sample)
        patched = {"prop_step": prop_step_plain,
                   "decode_aff_tail": decode_aff_tail_plain,
                   "dep_encode_front": dep_encode_front_plain}
        saved = {k: getattr(nlspn_mod, k) for k in patched}
        try:
            for k, fn in patched.items():
                setattr(nlspn_mod, k, fn)
            out_p = predictor.model(sample)
        finally:
            for k, fn in saved.items():
                setattr(nlspn_mod, k, fn)
    for key in ("pred", "aff", "pred_init"):
        err = (out_k[key] - out_p[key]).abs().max().item()
        rel = err / max(out_p[key].abs().max().item(), 1.0)
        log(f"[forward] {key}: kernels vs plain max_abs_err {err:.3e} rel {rel:.3e}")
        if not rel <= 2e-4:
            raise AssertionError(f"whole forward {key}: rel {rel:.3e} > 2e-4")
    for i, (pk, pp) in enumerate(zip(out_k["pred_inter"], out_p["pred_inter"])):
        rel = (pk - pp).abs().max().item() / max(pp.abs().max().item(), 1.0)
        if not rel <= 2e-4:
            raise AssertionError(f"whole forward pred_inter[{i}]: rel {rel:.3e}")

    # latency
    for b in (1, 4):
        res = predictor.benchmark(REQ_H, REQ_W, batch=b, calls=20, seed=3)
        log(f"[serve] b={b} predict_batch latency (CUDA events, host prep and "
            f"copies included): median {res['median_s'] * 1e3:.3f} ms, "
            f"min {res['min_s'] * 1e3:.3f} ms")
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
            log(f"[serve] b={b} model forward alone (CUDA events): median "
                f"{sorted(fwd)[5]:.3f} ms")

    # ---- 6. training ----
    del predictor
    torch.cuda.empty_cache()
    tcfg = Config()
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
    bwd_wrappers = {"prop_step_bwd": prop_step_bwd,
                    "decode_aff_tail_bwd": decode_aff_tail_bwd,
                    "dep_encode_front_bwd": dep_encode_front_bwd}
    train_wrappers = {**wrappers, **bwd_wrappers}
    per_step = {**per_forward, "prop_step_bwd": tcfg.prop_time,
                "decode_aff_tail_bwd": tcfg.prop_time - 1,
                "dep_encode_front_bwd": tcfg.prop_time - 1}

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
            raise AssertionError(f"train step {i}: launches {steps_launches}, "
                                 f"expected {per_step}")
        before = now
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"train step {i}: loss {losses[-1]}")
        if i == 0:
            for pname, p in model.named_parameters():
                if p.grad is None or not torch.isfinite(p.grad).all():
                    raise AssertionError(f"train step 0: {pname} has no finite "
                                         f"gradient")
    train_launches = count()
    log(f"[train] {TRAIN_STEPS} steps of {TRAIN_B} x {REQ_H}x{REQ_W}: losses "
        f"{[round(v, 4) for v in losses]}, finite; every parameter got a finite "
        f"gradient; launches {train_launches} = {per_step} per step")
    for k, n in train_launches.items():
        if n == 0:
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
    saved = {k: getattr(nlspn_mod, k) for k in patched}
    try:
        for k, fn in patched.items():
            setattr(nlspn_mod, k, fn)
        loss_p, grads_p = loss_and_grads()
    finally:
        for k, fn in saved.items():
            setattr(nlspn_mod, k, fn)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max(((grads_k[n] - grads_p[n]).norm().item()
                 / max(grads_p[n].norm().item(), 1e-30), n) for n in grads_p)
    log(f"[train] one step, kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {rel:.3e}); worst gradient {worst[1]} rel {worst[0]:.3e}")
    if not rel <= 1e-4:
        raise AssertionError(f"train step loss: rel {rel:.3e} > 1e-4")
    if not worst[0] <= 5e-3:
        raise AssertionError(f"train step gradient {worst[1]}: rel {worst[0]:.3e}")

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
    log(f"[train] b={TRAIN_B} train step (CUDA events, forward + loss + backward "
        f"+ Adam): median {sorted(step_ms)[len(step_ms) // 2]:.3f} ms, min "
        f"{min(step_ms):.3f} ms over {len(step_ms)} steps; peak memory "
        f"{peak / 2**30:.3f} GiB")
    ev = eng.eval_step(tbatches[0])
    if ev["loss_val"].shape != (TRAIN_B, 3) or ev["metric"].shape != (TRAIN_B, 8) \
            or not torch.isfinite(ev["loss_val"]).all():
        raise AssertionError("eval step: bad rows")
    log(f"[train] eval step: per-image loss {tuple(ev['loss_val'].shape)} and "
        f"metric {tuple(ev['metric'].shape)} rows, finite")

    # ---- 7. results ----
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
    }
    path_launches = {**launches, **{k: train_launches[k] for k in bwd_wrappers}}
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
