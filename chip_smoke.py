#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
hold every hand-written kernel against its plain PyTorch version there.

Run from the repository root, with one card:  python3 chip_smoke.py
(``python3 chip_smoke.py --dp-rank DIR`` is one rank of phase 16, and
``--ws-rank DIR`` one of phase 17; each phase starts its ranks itself.)

Phases (any failure exits non-zero and prints no result):
  1. the card: its name and power limit as nvidia-smi gives them;
  2. build every kernel of ``nlspn_eccv20_tpu_torch/csrc`` (one nvcc per
     source, all at once) into ``build/``;
  3. each forward kernel against its plain version on the card, at the
     serving path's shapes for B=1 and B=4 (NYU 228x304 requests, bucketed
     to 256x320); with each kernel's time, its plain version's time, one
     PyTorch library call's time where one computes the same function, and
     the least time the card could take (its bound). K1 (prop_step), equal
     bits to its plain version at every shape, also at B=1 with 5x5
     neighbours, at the train step's B=12 of 228x304, at B=12 on a 230x306
     plane (its scalar form) and at B=1 of KITTI's 240x1216, each timed
     beside its library call: replicate pad, F.unfold, the weighted sum and
     the blend. K7 (deform_prop) also
     at the train step's B=12 of 228x304 with offsets clamped to the
     window, on a 230x306 plane, with offsets far past its staged region
     (unclamped, N(0, 12^2)), and 5x5, every shape run twice for equal
     bits; at serving shapes its offsets reach past the window (eval has
     none); its library call is F.grid_sample over all K2 sampling grids
     stacked, then the affinity-weighted sum. K6 (prop_loop,
     the whole constant-affinity loop, on prop_loop_case's inputs, its
     launches held against its plan) at B=1 and B=4 of 256x320 and B=12
     of 228x304, also 5x5, 18 steps and 100 steps (regions past its
     threads' registers, split into launches) at B=1, with 12 (18)
     launches of K1 on the same inputs as its comparison (no single
     PyTorch call computes the loop); its training form (save=True) at
     B=12 and with 18 steps at B=1, every saved step input equal bits to
     the plain loop's, timed at both beside its bound; K6 and K7 also
     timed at B=1 of KITTI's 240x1216; K3
     (dep_encode_front) also timed at the train step's B=12 of 228x304 and
     at B=1 of KITTI's 240x1216, and checked on a 230x306 plane and with
     C1 = 96 (not a multiple of its 64-channel groups); K2
     (decode_aff_tail) also timed at the train step's B=12 (base grid 58x76,
     where its intermediate y1, which training saves for K4, is held
     against its plain version too) and at KITTI's 60x304, and checked at
     B=2, on an odd and ragged 57x75 grid and with C = 40 and 30, every
     shape's output and y1 run twice for equal bits: every cluster size the
     wrapper picks (8, 4, 2, 1) is run;
  4. each backward kernel the same way, at the train step's shapes (B=12
     and B=1, 228x304 patches), and run twice to show equal bits; K1b
     (prop_step_bwd) timed beside its library call, autograd's backward of
     K1's unfold form (F.fold, the replicate pad's backward, the products),
     also on the clip's ties at 3x3 and 5x5 and with the clip at B=12, with
     the forward's output (as PropStepFunction saves it) and without, on a
     230x306 plane at B=12 and at KITTI's 240x1216; K4
     (decode_aff_tail_bwd) and K5 (dep_encode_front_bwd) also at the
     shapes their tiles make risky: K4 with K=24 at B=1, K5 on a 230x306
     plane at B=2 and on KITTI's 240x1216 at B=1, K4 on its 60x304 base
     grid at B=1 and on an odd 58x75 one, both with C=30 at B=1; the
     library time is cuDNN's backward of the same two convs
     (aten.convolution_backward, what autograd runs for them), and for K8
     (deform_prop_bwd) aten.grid_sampler_2d_backward and the elementwise
     rest; K8 also on offsets at their ties (zero, integers, +-R), and
     timed where its binned gather is risky: 5x5 neighbours at R 4, R 1 and
     R 8, a 230x306 plane (sides not multiples of its 32x8 tiles), KITTI's
     240x1216 and converging offsets at B=12 (each neighbour of each output
     pointed at the nearest node of a grid 2R apart: its largest bins); K6b
     (prop_loop_bwd) from K6's saved step inputs, with 12 launches of K1b
     as its comparison, on the clip's ties at 3x3 and 5x5 (an all-zero
     corner, with the pre-blend), on 18 and 100 steps (launches of fewer
     steps, each adding to the sums), and at B=12 on a 230x306 plane and
     with 18 steps, and on the ties with every combination of preserve,
     clip, pre_blend and conf at 12 and 30 steps, each run twice for equal
     bits;
  5. serving: a Predictor on the default Config, given random weights
     (a model randomised from a seeded generator, its state_dict passed:
     the Predictor needs weights), answers 4 single requests and one batch of 4;
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
     versions, both with the deterministic algorithms cuDNN's heuristics
     pick (the same in every run; the kernels' step also run twice, its own
     difference printed); then the median step time and the peak memory;
  8. the same training run on Config(offset=True) (deform_prop and
     deform_prop_bwd 12 a step, the other four kernels 11, prop_step and
     prop_step_bwd 0), and one step of Config(offset=True, offset_window=0)
     at batch 2 (the exact gather, unclamped: deform_prop 12, its backward
     the exact gather's plain VJP, deform_prop_bwd 0), timed; that backward
     is autograd's through torch.gather, which scatters with atomic adds,
     so its first step runs twice from the same parameters and every
     parameter gradient is held within 5e-3 of the first run's, the
     largest difference printed;
  9. serving and training Config(use_GRU=False, prop_impl="pallas"), the
     constant-affinity loop: prop_loop 1 a forward and prop_loop_bwd 1 a
     backward, every other kernel 0;
 10. the op library (nlspn_eccv20_tpu_torch.ops): K9 small_conv3x3 against
     its plain version in float64 (F.conv2d over the concat; the library
     time is the same call in f32) at B=1 and B=4 of 256x320 and B=12 of
     228x304 (Ca 192, Cb 64, K 10) and B=2 of 57x75 with K 26; K9b
     small_conv3x3_bwd at B=12 and B=1 of 228x304, at B=2 of 57x75 with K
     26 and at B=1 with K 1, its library time cuDNN's backward of the
     concat conv; each twice for equal bits, its bound that of its design
     (bytes, or 3 TF32 passes on the tensor cores) with its f32 FMA bound
     printed beside it; their bf16 forms K9-bf16 small_conv3x3_bf16 (the
     same four shapes, the odd 57x75 through its padded copy of x; its plan
     from small_conv3x3_bf16_plan held equal to fwd_plan_bf16 at each) and
     K9b-bf16 small_conv3x3_bwd_bf16 (B=12 and B=1
     of 228x304, B=2 of 57x75 and of 57x76 with K 26, the three row
     widths: a multiple of 8, odd, even but not a multiple of 8; its plan
     from small_conv3x3_bwd_bf16_plan held equal to bwd_plan_bf16 at each)
     against their plain versions,
     which round per tap as the TPU kernel does, each twice for equal
     bits, timed beside cuDNN's bf16 conv over the concat or its backward
     and the bf16 bound; then the op-library path with the
     counters at 0: the heads identity (K9 with the fused stage-2 weights
     on the default model's and the offset model's stage-1 outputs and fe1
     equals their three *_dec0 convs, K 10 and 26), one autograd step
     through small_conv3x3_planar (K9 and K9b against the plain
     gradients) and one in bf16 (K9-bf16 and K9b-bf16; bf16 activations,
     f32 parameters, each gradient in its leaf's dtype), ModulatedDeformConvPack, DeformConvPack and
     DeformRoIPoolingPack forward and backward on the card against the
     same modules on the CPU, conv3x3_s2 / convt3x3_s2 against F.conv2d /
     F.conv_transpose2d, and propagate_step(impl="pallas") launching K1
     once and K7 once, equal to impl="xla", and under autograd with offsets
     in the window K7 and K8 once each, its gradients equal to impl="xla"'s;
 11. the devtools prototypes (nlspn_eccv20_tpu_torch.devtools): K10a
     deform_windowed and K10b deform_colgather equal bits to their plain
     versions and within 1e-5 of the exact gather at the experiments'
     shapes (b=12 of 228x304 and b=1 of 240x1216, R 4, offsets
     clip(N(0, 1.5^2), -4, 4)), each timed beside K7 on the same inputs,
     with the library time of F.grid_sample over the stacked grids and the
     weighted sum; K10a also 5x5 at b=1 of 228x304, equal bits, timed
     beside its library time and its bytes bound; K10c gather_probe equal
     bits to its plain version along both axes, negative indices too, its
     library time torch.gather, and beside it the launch floor (a
     one-element zero_, timed the same way); then the devtools path with
     the counters at 0: propagate_deformable_pallas forward and backward
     at b=12 (K10a and K8 against the plain versions within 1e-5, offsets
     inside the window and beyond it, to +-5.5), exp_deform3.main() and
     exp_deform2.main();
 12. the interleave microbenchmarks (devtools.microbench_interleave and
     microbench_asm): K11a interleave_asm, K11b interleave_strided, K11c
     tile_repeat_probe and K11d interleave_onehot (with the one-hot E)
     equal bits to their plain versions at b=12 of (12, 128, 64, 128)
     phases whose padding is random, so a read outside the 58x76 window
     shows; K11a, K11b and K11d also equal bits to the interleave, K11c (a
     probe, not an interleave) to its own formula only; K11a, K11b and K11d
     also at b=1 and at b=12 of unaligned (59, 77) padded planes (the
     scalar forms of K11b and K11d), equal bits there too; K11d with a
     random E against its plain version, its error printed with the
     number of bf16 passes; K11d's
     bound that of its design (6 bf16 passes on the tensor cores), its f32
     FMA bound printed beside it; the library time of K11a, K11b and K11d
     the .contiguous() copy of the permuted window, of K11c one
     advanced-indexing gather; then, with the counters at 0, the two
     microbenchmarks' main()s (deconv0's NCHW and channels-last outputs
     must agree);
 13. the CLI path (``nlspn_eccv20_tpu_torch.main``), in a temporary
     directory under ``build/``, with the counters at 0 before each run:
     ``main`` at the defaults on the synthetic scenes with --test_pipeline
     --epochs 1 (one train step of batch 12 of 228x304, the val and test
     forwards at b=1: launches 12/11/11 three times forward and once
     backward), every artifact written; the resume of that run for a second
     epoch (its first lr the schedule's at step steps_per_epoch, the same
     launches); --test_only --pretrain the run (one forward; its test row
     within 2e-4 of the resumed run's); Predictor(checkpoint=<the .pt>)
     answering one 228x304 request within 2e-4 of the plain versions'
     forward; each run's wall time and images/s, the checkpoint's size and
     whether the native data library built;
 14. bf16 serving (precision="bf16"): K2-bf16 (decode_aff_tail_bf16) and
     K3-bf16 (dep_encode_front_bf16) against their bf16 plain versions at
     the serving shapes (B=1 and B=4 of 256x320), at KITTI's B=1 (K2's
     60x304 base grid, K3's 240x1216 plane), K2 also at B=2 and B=12 and
     on the odd 57x75 grid, with K=24, with C = 40 and 30 and on 29x38 and
     40x64 grids (every cluster size its source's plan picks, 8, 4, 2 and 1, runs;
     the plan that dec_aff_tail_bf16_plan reports held equal to
     tail_plan_bf16, the mirror the CPU tests check), K3 also at the
     train step's B=12 of 228x304, with C1 = 96 and on a 230x306 plane
     (its plan from dep_encode_front_bf16_plan held equal to
     front_plan_bf16 at each shape); each shape twice for equal bits,
     within one bf16 ulp of the largest plain output (2^-7 of it), K2's
     output and its training form's y1 (decode_aff_tail_fwd_y1) and K3's
     output each at most 1e-2 not bit-equal (a rounding per shift or per
     tap, or of a partial sum, puts far more off), timed beside its
     plain version,
     cuDNN's two bf16 convs (the library time) and its bound (2-byte
     inputs; bf16 operations at the tensor cores' peak); then the three
     configurations served through a Predictor in bf16 at full width (4
     b=1 requests and one b=4 batch of 228x304, counters at 0 just before:
     prop_step 12, decode_aff_tail_bf16 and dep_encode_front_bf16 11 a
     forward on the default path, deform_prop 12 with offsets, prop_loop 1
     on the loop path, the f32 K2 and K3 0), outputs finite, observed depth
     kept exactly, the bf16 forward through the kernels within 1e-2 of
     max |pred| of the bf16 forward through the plain versions, the gap to
     the f32 forward at the same weights printed, and latency and device
     busy time a forward at b=1 and b=4 in bf16 beside f32; then phase
     13's checkpoint tested with --precision bf16 --test_only (its metric
     row printed beside the f32 test row);
 15. bf16 training: K4-bf16 (decode_aff_tail_bwd_bf16) and K5-bf16
     (dep_encode_front_bwd_bf16) against their bf16 plain versions at the
     train step's B=12 and at B=1 of 228x304, K4 also with K=24 on an odd
     57x75 grid and with C=30, K5 with C1 = 96 and 30 and on a 230x306
     plane at B=2 (K5-bf16's dP0 plan, dep_encode_front_bwd_bf16_plan,
     held equal to its mirror front_bwd_plan_bf16 at each shape); each
     shape twice for equal bits, every output within
     one bf16 ulp of its largest plain value (2^-7 of it), timed beside
     its plain version, cuDNN's bf16 backward of the same two convs (the
     library time) and its bound; then 5 bf16 train steps of each
     configuration at batch 12 of 228x304 (launches 11 K4-bf16 and 11
     K5-bf16 a step on the default and offset paths, none on the loop's;
     finite losses; every parameter a finite f32 gradient), one step
     through the kernels against the same step through their plain
     versions (the plain bf16 forward and backward as autograd Functions)
     from the same parameters under cuDNN's deterministic algorithms
     (loss within 1e-2, each gradient within 5e-2 relative L2 or twice
     the plain bf16 step's distance from the f32 step), and the bf16
     step's time and peak memory beside the f32 step's at the same
     initial weights; then main --precision bf16 in its own temporary
     directory: one epoch trained, resumed for a second, --test_only, its
     checkpoint's weights f32 and served by an f32 Predictor;
 16. data parallel (``parallel/mesh.py``): (a) two ranks on the one card,
     two subprocesses of this script with torchrun's variables set here and
     a gloo group (NCCL refuses two ranks on one card), each taking the
     default configuration's f32 train step, then its bf16 one, on 6 of
     phase 7's 12 images of 228x304 from the same random weights (seed 4,
     broadcast by rank 0), against the one-process step on all 12 here,
     with the deterministic algorithms cuDNN's heuristics pick on both
     sides: f32 loss within 1e-4 and each gradient (summed over the ranks)
     within 5e-3 relative L2,
     bf16 at phase 15's bars (loss 1e-2; each gradient within
     min(max(5e-2, 2 x the one-process bf16-vs-f32 distance), 0.5), norms
     3/4 to 4/3); both ranks' weights and BatchNorm running statistics
     equal bits after the step; launches 12/11/11 forward and backward on
     each rank (bf16: K2-K5 in their bf16 forms); the rank step's median of
     5 in cuDNN's benchmark mode (gloo all-reduces through the host) beside
     the one-process step's and phase 7's, with the card's name and power
     limit; (b) ``torchrun
     --nproc_per_node 1 -m nlspn_eccv20_tpu_torch.main --data_name
     Synthetic --test_pipeline --epochs 1``: an NCCL group of one rank, the
     synchronised BatchNorm and the rank-0 writers on the card, exit 0 and
     every artifact; each subprocess killed at its time limit (480 s);
 17. width sharding (``num_spatial_shards``, ``parallel/halo.py``): (0)
     K1, K1b, K2, K4, K3, K5, the bf16 forms of K2-K5, K7 and K8 against
     their plain versions, at their usual bars, at every shape the strips
     below give them (B=2; each strip extended by its halo: K1 240x609,
     409, 402; K3 240x608, 612, 408, 404, 412; K2 60x153, 152, 103, 101,
     102; the default model's backwards at two strips' shapes; K7 and K8 in
     training by the windowed backward's reach prop_kernel // 2 + R + 1 = 6
     a side, 240x614, 414, 412; K7 in eval by the reach of the offsets
     (prop_kernel // 2 + ceil(max |dx|) + 1 a side, predicted from the
     one-process offsets) and on the whole 240x1216); then gloo ranks on
     the one card as subprocesses of this script (``--ws-rank``), each
     noting the shapes the model gave K1, K7, K2, K3 and K8 (every one must
     be among those checked; one not predicted is checked when the ranks
     return, and named), the runs of ``WS_RUNS`` at KITTI's full 240x1216,
     global batch 2 of synthetic scenes, random weights (seed 4), against
     the same runs in one process: the default configuration and
     ``Config(offset=True)``; (a) two strips of 608 columns: the eval
     forward (pred gathered within 2e-4 of the one-process forward here,
     the per-image metric rows within 1e-4; in bf16 within 1e-2 of max
     |pred| of the one-process bf16 forward; the gap on the 16 columns
     around each seam printed), the f32 train step (loss within 1e-4, each
     gradient summed over the ranks within 5e-3 relative L2 of the nearer
     of two one-process steps, both under the deterministic algorithms
     cuDNN's heuristics pick: through cuDNN, and through PyTorch's own
     convolutions; both distances printed) and the bf16 step at phase 15's
     bars; every rank's weights and running statistics equal bits after
     each step; launches on each rank 12/11/11 forward (K1 or K7, K2, K3 on
     the strip and its halo) and backward (K1b or K8, K4, K5; their bf16
     forms in bf16), K1 none with offsets; the halo exchanges counted with
     the bytes each rank sends; the offset model's eval twice, at its own
     offsets (a halo of their reach) and with the offset head scaled so
     that max |dx| is ``WS_FAR_DX`` (the whole width: ``gather_width``),
     the route each rank took held to the one its offsets ask for, the
     train step's a halo of 6; the rank step's median of 3 in cuDNN's
     benchmark mode beside the one-process step's, labelled as ranks
     sharing one card, with the card's name and power limit; (b) three
     strips of 408, 400 and 408 columns (ragged): the eval forwards at the
     same bars, and the offset model's f32 train step; each group of
     subprocesses killed at its time limit (420 s);
 18. the kernel line, then {"ok": true, "device": ...} as the last line.

TF32 is off for cuDNN and for matmuls: every f32 number here is float32
(phases 14 and 15 run bf16 where the configuration says so). cuDNN runs in
benchmark mode (it times its algorithms per conv shape), as the serving and
training paths do.
Tolerances: relative error = max |kernel - plain| / max |plain|;
prop_step, prop_step_bwd, deform_prop, deform_prop_bwd, prop_loop,
prop_loop_bwd, deform_windowed and deform_colgather <= 1e-5 (the
forwards: same operations in the same order, equal bits expected, and
required of deform_windowed and deform_colgather; the
backwards: sums of at most 9, or (2R+2)^2 = 100,
products a neighbour, and of 12 steps, in another order),
decode_aff_tail(_bwd), dep_encode_front(_bwd) and small_conv3x3(_bwd)
<= 1e-4 (f32 sums of up to 2,304 products, or a whole batch's pixels, in
another order; small_conv3x3(_bwd), the heads identity and spaceconv are
held against their plain versions run in float64, since cuDNN's own f32
backward of that conv is 1.4e-4 off), the DCN modules (card against CPU)
<= 1e-4, K11a-c and K11d with the one-hot E equal bits (copies; one
product not zero in each sum, whose three exact bf16 pieces K11d sums
exactly), K11d with a random E <= 1e-5 (sums of 304 products in another
order, and its split drops products below 2^-21 of each), deconv0 channels-last against NCHW <= 1e-4,
whole forward <= 2e-4 (PARITY.md's forward bar), whole train step:
loss <= 1e-4 and each parameter's gradient ||kernels - plain|| / ||plain||
<= 5e-3 (PARITY.md's gradient bar); the bf16 kernels (K2-K5, K9, K9b
bf16) <= 2^-7 (one bf16 ulp: a sum in another order can round to the
neighbouring bf16 value), a bf16 input gradient not bit-equal on at most
1e-3 of its elements, an f32 weight or bias gradient of a bf16 kernel
<= 5e-4, the bf16 forward <= 1e-2 of max |pred|, the bf16 train step as
phase 15 says (a rounding tie flips a ReLU mask, and bf16 itself moves a
gradient by up to 0.1-0.4 relative L2 against f32).
The kernel line's launches are each kernel's count on its path: the
default serving run's for the forward kernels, the default training run's
for the backward ones, the offset runs' for deform_prop and deform_prop_bwd,
the constant-affinity runs' for prop_loop and prop_loop_bwd, the bf16
default serving run's for decode_aff_tail_bf16 and dep_encode_front_bf16,
the bf16 default training run's for decode_aff_tail_bwd_bf16 and
dep_encode_front_bwd_bf16,
the op-library
path's for small_conv3x3, small_conv3x3_bwd and their bf16 forms, the devtools path's for
deform_windowed, deform_colgather and gather_probe (gather_probe: equal bits),
the two microbenchmark main()s' for K11a-d.
"""

import contextlib
import copy
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# Peak rates of the card (NVIDIA data sheets, dense, no sparsity), by part:
# float32 outside the tensor cores, bf16 and TF32 on the tensor cores
# (K11d's and K9b's designs) and HBM bandwidth.
PEAKS = {"SXM": {"f32_tflops": 67.0, "bf16_tflops": 989.0, "tf32_tflops": 494.7,
                 "hbm_tbps": 3.35},
         "PCIe": {"f32_tflops": 51.0, "bf16_tflops": 756.0, "tf32_tflops": 378.0,
                  "hbm_tbps": 2.0}}

H, W = 256, 320            # NYU 228x304 requests in the 32-pixel bucket
REQ_H, REQ_W = 228, 304
TRAIN_B = 12               # Config() defaults: batch 12 of 228x304 patches
TRAIN_STEPS, TIMED_STEPS = 5, 10
RADIUS = 4                 # Config().offset_window
KITTI_H, KITTI_W = 240, 1216
LOOP = dict(use_GRU=False, prop_impl="pallas")   # the whole-loop route


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
    from nlspn_eccv20_tpu_torch.ops.affinity import normalize_affinity
    from nlspn_eccv20_tpu_torch.ops.kernels import build
    from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
        SPLITS, decode_aff_tail, decode_aff_tail_bf16, decode_aff_tail_bwd,
        decode_aff_tail_bwd_bf16, decode_aff_tail_bwd_case, decode_aff_tail_bwd_plain,
        decode_aff_tail_bwd_plain_bf16, decode_aff_tail_case, decode_aff_tail_fwd_y1,
        decode_aff_tail_plain, decode_aff_tail_plain_bf16, decode_aff_tail_plain_bf16_y1,
        decode_aff_tail_plain_y1, tail_plan, tail_plan_bf16, tail_plan_bf16_card)
    from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import (
        deform_prop, deform_prop_bwd, deform_prop_bwd_case, deform_prop_bwd_plain,
        deform_prop_case, deform_prop_fwd_plain, deform_prop_plain, sampling_grid)
    from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import fwd_plan as deform_fwd_plan
    from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
        dep_encode_front, dep_encode_front_bf16, dep_encode_front_bwd,
        dep_encode_front_bwd_bf16, dep_encode_front_bwd_case, dep_encode_front_bwd_plain,
        dep_encode_front_bwd_plain_bf16, dep_encode_front_case, dep_encode_front_plain,
        dep_encode_front_plain_bf16, front_bwd_plan_bf16, front_bwd_plan_bf16_card,
        front_plan_bf16, front_plan_bf16_card)
    from nlspn_eccv20_tpu_torch.ops.kernels.prop_loop import (
        launch_fwd as launch_loop, plan as loop_plan, prop_loop, prop_loop_bwd,
        prop_loop_bwd_case, prop_loop_bwd_plain, prop_loop_case, prop_loop_plain)
    from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
        prop_step, prop_step_bwd, prop_step_bwd_case, prop_step_bwd_plain, prop_step_case,
        prop_step_plain)
    from nlspn_eccv20_tpu_torch.ops.kernels.small_conv3x3 import (
        bwd_plan_bf16, bwd_plan_bf16_card, fuse_heads_dec0, fwd_plan_bf16,
        fwd_plan_bf16_card, small_conv3x3_bf16,
        small_conv3x3_bwd, small_conv3x3_bwd_bf16,
        small_conv3x3_bwd_case, small_conv3x3_bwd_plain, small_conv3x3_bwd_plain_bf16,
        small_conv3x3_case, small_conv3x3_plain, small_conv3x3_plain_bf16,
        small_conv3x3_planar)
    from nlspn_eccv20_tpu_torch import ops as oplib
    from nlspn_eccv20_tpu_torch.devtools import exp_deform2, exp_deform3
    from nlspn_eccv20_tpu_torch.devtools.exp_deform2 import (probe_gather,
                                                            probe_gather_plain)
    from nlspn_eccv20_tpu_torch.devtools.exp_deform3 import (deform_colgather,
                                                            deform_colgather_plain)
    from nlspn_eccv20_tpu_torch.devtools.exp_deform_prop_kernel import (
        deform_windowed, propagate_deformable_pallas)
    from nlspn_eccv20_tpu_torch.devtools import microbench_asm, microbench_interleave
    from nlspn_eccv20_tpu_torch.devtools.measure import measure
    from nlspn_eccv20_tpu_torch.devtools.microbench_asm import (
        E_SHAPE, ONEHOT_PASSES, interleave_onehot, interleave_onehot_plain,
        interleave_strided, interleave_strided_plain, onehot_expansion, tile_repeat_probe,
        tile_repeat_probe_plain)
    from nlspn_eccv20_tpu_torch.devtools.microbench_interleave import (
        PADDED, PHASES, interleave_asm, interleave_asm_plain, interleave_window)
    from nlspn_eccv20_tpu_torch.ops import spaceconv
    from nlspn_eccv20_tpu_torch.ops.propagate import (
        clamp_offsets, neighbor_shifts, propagate_deformable_exact_planar,
        propagate_deformable_windowed_planar)
    from nlspn_eccv20_tpu_torch.models import get_model
    from nlspn_eccv20_tpu_torch import main as cli_main
    from nlspn_eccv20_tpu_torch.config import parse_args
    from nlspn_eccv20_tpu_torch.data import native as cli_native
    from nlspn_eccv20_tpu_torch.serve import Predictor
    from nlspn_eccv20_tpu_torch.train import Engine
    from nlspn_eccv20_tpu_torch.utils.checkpoint import CheckpointManager
    from nlspn_eccv20_tpu_torch.utils.optim import make_lr_schedule
    from nlspn_eccv20_tpu_torch.utils.weights import randomize_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # main's kernel build cache off: its runs here (phases 13, 15, 16) and
    # their subprocesses load what phase 2 built in build/
    os.environ["NLSPN_COMPILE_CACHE"] = "0"
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

    def time_ms(fn, reps=20):
        """Device time of one call: CUDA-graph replay of `reps` back-to-back
        calls between two CUDA events (no host launch cost), median of 5,
        after a warm-up."""
        return 1e3 * measure(fn, calls=reps, warmup=1)

    def rel_err(out, ref):
        err = (out - ref).abs().max().item()
        return err, err / max(ref.abs().max().item(), 1e-30)

    def bound(nbytes, flops, rate="f32_tflops"):
        t_bytes = nbytes / (peak["hbm_tbps"] * 1e12) * 1e3
        t_ops = flops / (peak[rate] * 1e12) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def taps_t2(n):   # (output, tap) pairs of a k3/s2/p1/op1 transposed conv
        return 3 * n - 1

    def taps_s2(n):   # (output, tap) pairs of a k3/s2/p1 conv over n inputs
        n1 = (n + 1) // 2
        return 3 * n1 - 1 - (n % 2)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # made here: no host copy in a captured graph
    shifts3 = torch.tensor(neighbor_shifts(3), device=dev, dtype=torch.float32)

    def deform_flops(b, h, w, k2):
        # a neighbour: 4 taps x (conf, weight, product, sum) and 8 for the
        # fractions and weights, 2 for the affinity; the blend
        return b * h * w * (26 * k2 + 5)

    # ---- 3. each forward kernel against its plain version ----
    rows = {}

    def record(kname, b, err, rel, tol, ms, plain_ms, lib_ms, bnd, main_b=1,
               shape=""):
        """Log one kernel's check and times; the kernel line keeps those
        at batch ``main_b`` (the serving path's 1, the train step's 12) of
        the path's own shape (``shape`` empty)."""
        if not rel <= tol:
            raise AssertionError(
                f"{kname} B={b}{shape}: relative error {rel:.3e} > {tol:.0e}")
        r = rows.setdefault(kname, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log(f"[kernel] {kname} B={b}{shape}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {tol:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        if b == main_b and not shape:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bnd[0], bound_by=bnd[1])

    def check_loop(b, h, w, kernel=3, steps=12, timed=True, row=True, save=False):
        """K6 against its plain version on prop_loop_case's inputs (the
        model's options: conf, preserve, no clip, no pre-blend), its
        launches against its plan; with ``save`` also its training form,
        every one of the ``steps`` step inputs it saves held against the
        plain loop's, equal bits; if ``timed``, its times and bounds (the
        training form's too) and those of ``steps`` launches of K1 on the
        same inputs (the per-step route), kept in the kernel line's row if
        ``row``."""
        args, kw, per_step = prop_loop_case(gen, dev, b, h, w, kernel, steps)
        opts = {k: v for k, v in kw.items() if k != "save"}
        pred, aff, conf, dep = args
        n0 = prop_loop.launches
        out = prop_loop(*args, **opts)
        n = prop_loop.launches - n0
        ref = prop_loop_plain(*args, **opts)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tag = f"prop_loop {kernel}x{kernel} {steps} steps B={b} {h}x{w}"
        tile, chunks = loop_plan(steps, kernel, (b, h, w), sms)
        if n != len(chunks):
            raise AssertionError(f"{tag}: {n} launches, the plan has {len(chunks)}")
        if not rel <= 1e-5:
            raise AssertionError(f"{tag}: relative error {rel:.3e} > 1e-5")
        log(f"[kernel] {tag}: {n} launch(es) of {tile}x{tile} tiles, rel {rel:.3e}, "
            f"equal bits {torch.equal(out, ref)}")
        # per step and pixel: 2 a tap, the blend's 4, conf's 1
        flops = b * h * w * steps * (2 * kernel * kernel + 5)
        if save:
            out_s, saved = launch_loop(*args, save=True, **opts)
            cur, other = pred, []
            for s in range(steps):
                if not torch.equal(saved[s], cur):
                    other.append(s)
                cur = prop_step_plain(cur, aff, conf, dep, kernel=kernel, preserve=True,
                                      clip=False)
            if other or not torch.equal(out_s, out):
                raise AssertionError(f"{tag}: the training form's saved step inputs "
                                     f"{other} (or its output) differ from the plain "
                                     f"loop's")
            log(f"[kernel] {tag}: training form: all {steps} saved step inputs equal "
                f"bits to the plain loop's")
            if timed:
                # reads pred, conf, dep, the K2 planes; writes out and the steps
                # saved planes
                bnd_s = bound(nbytes(*args, out, saved), flops)
                log(f"[kernel] {tag}: training form (save=True) kernel "
                    f"{time_ms(lambda: launch_loop(*args, save=True, **opts)):.4f} ms, "
                    f"bound {bnd_s[0]:.4f} ms ({bnd_s[1]})")
        if not timed:
            return
        log(f"[kernel] {tag}: {steps} x K1 prop_step on the same inputs "
            f"{time_ms(per_step):.4f} ms")
        ms = time_ms(lambda: prop_loop(*args, **opts))
        bnd = bound(nbytes(*args, out), flops)
        if row:
            record("prop_loop", b, err, rel, 1e-5, ms,
                   time_ms(lambda: prop_loop_plain(*args, **opts)), None, bnd)
        else:
            log(f"[kernel] {tag}: kernel {ms:.4f} ms, bound {bnd[0]:.4f} ms "
                f"({bnd[1]})")

    def same_bits(fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)

    def check_k1(b, h, w, kernel=3):
        """K1 against its plain version on prop_step_case's inputs, equal
        bits, and its times beside its yardstick (replicate pad, F.unfold,
        the weighted sum and the blend); the kernel line keeps the serving
        shape's."""
        args, kw, library = prop_step_case(gen, dev, b, h, w, kernel)
        out = prop_step(*args, **kw)
        ref = prop_step_plain(*args, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        shape = "" if (h, w, kernel) == (H, W, 3) else f" {h}x{w} {kernel}x{kernel}"
        if not torch.equal(out, ref):
            raise AssertionError(f"prop_step B={b}{shape}: not the plain version's bits "
                                 f"(rel {rel:.3e})")
        log(f"[kernel] prop_step B={b}{shape}: equal bits to the plain version")
        k2 = kernel ** 2
        record("prop_step", b, err, rel, 1e-5, time_ms(lambda: prop_step(*args, **kw)),
               time_ms(lambda: prop_step_plain(*args, **kw)), time_ms(library),
               bound(nbytes(*args, out), b * h * w * (2 * k2 + 5)), shape=shape)

    def check_k7(b, h, w, kernel=3, radius=None, off_std=1.5):
        """K7 against its plain version on deform_prop_case's inputs (offsets
        ~ N(0, off_std^2), clamped to [-radius, radius] with a radius, as
        training clamps them; else unclamped, as served), run twice for
        equal bits; how many offsets reach past the staged region (the
        kernel reads their taps from device memory). The kernel line keeps
        the serving shape's times (3x3, unclamped N(0, 1.5^2))."""
        args, kw, library = deform_prop_case(gen, dev, b, h, w, kernel, radius, off_std)
        fn = lambda: (deform_prop(*args, **kw),)
        out = fn()[0]
        ref = deform_prop_fwd_plain(*args, kernel=kernel, preserve=True, clip=False)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        _, lib_rel = rel_err(library(), ref)
        r_s = deform_fwd_plan(b, h, w, kernel, radius, sms)[2] - kernel // 2 - 1
        tag = ("" if (h, w, kernel, radius, off_std) == (H, W, 3, None, 1.5) else
               f" {h}x{w} {kernel}x{kernel} "
               f"{'R=' + str(radius) if radius is not None else 'unclamped'} "
               f"offsets N(0, {off_std}^2)")
        if not rel <= 1e-5 or not same_bits(fn):
            raise AssertionError(f"deform_prop B={b}{tag}: rel {rel:.3e} or other bits")
        if not lib_rel <= 1e-3:
            raise AssertionError(f"deform_prop B={b}{tag}: grid_sample yardstick rel "
                                 f"{lib_rel:.3e}")
        log(f"[kernel] deform_prop B={b}{tag}: max|offset| {args[1].abs().max().item():.2f}, "
            f"{(args[1].abs() > r_s).float().mean().item():.2%} of the offsets past the "
            f"staging radius {r_s}; equal bits to the plain version "
            f"{torch.equal(out, ref)}, and in two runs; grid_sample yardstick rel "
            f"{lib_rel:.1e}")
        record("deform_prop", b, err, rel, 1e-5, time_ms(lambda: deform_prop(*args, **kw)),
               time_ms(lambda: deform_prop_fwd_plain(*args, kernel=kernel, preserve=True,
                                                     clip=False)),
               time_ms(library),
               bound(nbytes(*args, out), deform_flops(b, h, w, kernel * kernel)), shape=tag)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k2_splits = set()

    def check_k2(b, hg, wg, k=8, c=256, timed=False):
        """K2 (decode_aff tail) against its plain version on a base grid
        hg x wg x c with K = k output channels: its output and the
        intermediate y1 that training reads, each run twice for equal bits;
        with ``timed`` its time beside cuDNN's two transposed convs and its
        bound (the kernel line keeps the serving grid's)."""
        args, library = decode_aff_tail_case(gen, dev, b, hg, wg, k, c)
        out, y1 = decode_aff_tail_fwd_y1(*args)
        ref, y1_ref = decode_aff_tail_plain_y1(*args)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        _, rel_y1 = rel_err(y1, y1_ref)
        split = tail_plan(b, hg, wg, c, sms)[2]
        k2_splits.add(split)
        shape = "" if (hg, wg, k, c) == (H // 4, W // 4, 8, 256) else f" {hg}x{wg} K={k} C={c}"
        tag = f"decode_aff_tail B={b}{shape}"
        if not rel_y1 <= 1e-4:
            raise AssertionError(f"{tag}: y1 relative error {rel_y1:.3e} > 1e-4")
        if not (same_bits(lambda: decode_aff_tail_fwd_y1(*args))
                and same_bits(lambda: (decode_aff_tail(*args),))):
            raise AssertionError(f"{tag}: two runs gave other bits")
        log(f"[kernel] {tag}: cluster of {split}, y1 rel {rel_y1:.3e}, out and y1 "
            f"equal bits in two runs")
        if not timed:
            if not rel <= 1e-4:
                raise AssertionError(f"{tag}: relative error {rel:.3e} > 1e-4")
            log(f"[kernel] {tag}: rel {rel:.3e}")
            return
        flops = 2 * b * (taps_t2(hg) * taps_t2(wg) * c * 16
                         + taps_t2(2 * hg) * taps_t2(2 * wg) * 16 * k)
        record("decode_aff_tail", b, err, rel, 1e-4,
               time_ms(lambda: decode_aff_tail(*args)),
               time_ms(lambda: decode_aff_tail_plain(*args)), time_ms(library),
               bound(nbytes(*args, out), flops), shape=shape)
        if b == TRAIN_B:
            log(f"[kernel] {tag}: with y1 written, as in training, "
                f"{time_ms(lambda: decode_aff_tail_fwd_y1(*args)):.4f} ms")

    def check_k3(b, h, w, c=256):
        """K3 (encode_dep front) against its plain version on an h x w plane
        -> ceil(ceil(h/2)/2) x ceil(ceil(w/2)/2) x c, timed beside cuDNN's
        two convs; the serving shapes at C1 = 256 fill the kernel line."""
        args, library = dep_encode_front_case(gen, dev, b, h, w, c)
        out = dep_encode_front(*args)
        ref = dep_encode_front_plain(*args)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        flops = 2 * b * (taps_s2(h) * taps_s2(w) * 16
                         + taps_s2((h + 1) // 2) * taps_s2((w + 1) // 2) * 16 * c)
        record("dep_encode_front", b, err, rel, 1e-4,
               time_ms(lambda: dep_encode_front(*args)),
               time_ms(lambda: dep_encode_front_plain(*args)), time_ms(library),
               bound(nbytes(*args, out), flops),
               shape="" if (h, w, c) == (H, W, 256) else f" {h}x{w} C1={c}")

    for b in (1, 4):
        # K1: the fork default's step (3x3, conf, preserve, no clip); 5x5
        check_k1(b, H, W)
        if b == 1:
            check_k1(b, H, W, kernel=5)

        # K6: the constant-affinity loop as the model calls it; also 5x5
        # (launches of 2 steps), 18 steps (two launches, with the training
        # form's saved step inputs) and 100 (launches of 11 or 12)
        check_loop(b, H, W)
        if b == 1:
            check_loop(b, H, W, kernel=5, row=False)
            check_loop(b, H, W, steps=18, save=True, row=False)
            check_loop(b, H, W, steps=100, timed=False)

        # K2: decode_aff tail, base grid 64x80, 256 -> 16 -> K
        check_k2(b, H // 4, W // 4, timed=True)
        if b == 1:
            check_k2(b, H // 4, W // 4, k=24)

        # K3: encode_dep front, 256x320 plane -> 64x80x256; an odd shape the
        # TPU kernel refused: the CUDA kernel takes it
        check_k3(b, H, W)
        if b == 1:
            check_k3(1, 230, 306)

        # K7: the offset step as served (eval: offsets also past the window)
        check_k7(b, H, W)
        if b == 1:
            check_k7(b, H, W, kernel=5)

    # K7 at the train step's shape, offsets clamped to the window (the
    # training path passes the window as its radius: the staging radius)
    check_k7(TRAIN_B, REQ_H, REQ_W, radius=RADIUS)
    # K7 on a plane whose sides are no multiple of its tiles, and with
    # offsets far past its staged region (unclamped, as served: most taps
    # read device memory); K1 at the train step's shape (12 launches a step)
    check_k7(TRAIN_B, 230, 306, radius=RADIUS)
    check_k7(TRAIN_B, REQ_H, REQ_W, off_std=12.0)
    check_k1(TRAIN_B, REQ_H, REQ_W)
    # K1 on a plane whose width is no multiple of 4 (its scalar form) and
    # at KITTI's width
    check_k1(TRAIN_B, 230, 306)
    check_k1(1, KITTI_H, KITTI_W)

    # K2 at the train step's base grid (232 rows of the 228-row patch: y1
    # is held against its plain version there), at KITTI's, on an odd and
    # ragged one, with C = 40 and 30 (channels not in whole stages, nor in
    # 16-byte groups) and at b=2 (a cluster of 4): every cluster size the
    # wrapper picks
    check_k2(TRAIN_B, 58, 76, timed=True)
    check_k2(1, KITTI_H // 4, KITTI_W // 4, timed=True)
    check_k2(2, H // 4, W // 4)
    check_k2(1, 57, 75)
    check_k2(1, H // 4, W // 4, c=40)
    check_k2(1, 58, 76, c=30)
    if k2_splits != set(SPLITS):
        raise AssertionError(f"decode_aff_tail: cluster sizes {sorted(k2_splits)} "
                             f"checked, the wrapper picks {SPLITS}")

    # K3 at the train step's shape, at KITTI's width and with C1 = 96
    check_k3(TRAIN_B, REQ_H, REQ_W)
    check_k3(1, KITTI_H, KITTI_W)
    check_k3(1, REQ_H, REQ_W, c=96)

    # K6 at the train step's shape, with its training form's saved step
    # inputs; K6 and K7 at KITTI's width, B=1
    check_loop(TRAIN_B, REQ_H, REQ_W, save=True)
    check_loop(1, KITTI_H, KITTI_W, row=False)
    check_k7(1, KITTI_H, KITTI_W)

    # ---- 4. each backward kernel against its plain version ----
    conv_bwd = torch.ops.aten.convolution_backward

    def grads_err(got, want):
        """max_abs_err and relative error over all of a kernel's outputs
        (an output absent from both, as d_conf without conf, is skipped)."""
        errs = [rel_err(a, b) for a, b in zip(got, want) if b is not None]
        return max(e for e, _ in errs), max(r for _, r in errs)

    def check_bwd(kname, b, fn, plain, tol, lib, bnd, plain_reps=20, ref=None,
                  shape=""):
        """``ref``: what the kernel is held against, the plain version by
        default (timed as ``plain``). ``shape`` names a shape other than
        the train step's; such a check stays out of the kernel line's
        times."""
        got, want = fn(), (ref or plain)()
        torch.cuda.synchronize()
        err, rel = grads_err(got, want)
        if not same_bits(fn):
            raise AssertionError(f"{kname} B={b}{shape}: two runs gave other bits")
        record(kname, b, err, rel, tol, time_ms(fn), time_ms(plain, reps=plain_reps),
               None if lib is None else time_ms(lib), bnd, main_b=TRAIN_B, shape=shape)
        log(f"[kernel] {kname} B={b}{shape}: two runs, equal bits")

    def check_k8(b, h, w, kernel=3, radius=RADIUS, converge=False):
        """K8 (the offset step's backward) against its plain version on an
        h x w plane, offsets clamped to the window ``radius`` (converging
        with ``converge``); returns its inputs."""
        args, kw, library = deform_prop_bwd_case(gen, dev, b, h, w, kernel,
                                                 radius, converge)
        outs = deform_prop_bwd(*args, **kw)
        shape = ("" if (h, w, kernel, radius, converge) == (REQ_H, REQ_W, 3, RADIUS, False)
                 else f" {h}x{w} {kernel}x{kernel} R={radius}"
                      f"{' converging' if converge else ''}")
        # per pixel and neighbour: up to 3x3 taps of value and two slopes,
        # and the four corners' scatter
        check_bwd("deform_prop_bwd", b, lambda: deform_prop_bwd(*args, **kw),
                  lambda: deform_prop_bwd_plain(*args, **kw), 1e-5, library,
                  bound(nbytes(*args, *outs), b * h * w * (kernel * kernel * 60 + 10)),
                  plain_reps=2, shape=shape)
        return args

    def check_k6b(b, h, w, kernel=3, steps=12, ties=False):
        """K6b (the constant-affinity loop's backward) against its plain
        version on ``prop_loop_bwd_case``'s inputs, run twice for equal
        bits; as the model calls it (3x3, 12 steps, no ties) on the train
        step's plane it is timed beside 12 launches of K1b."""
        args, kw, library = prop_loop_bwd_case(gen, dev, b, h, w, kernel, steps, ties)
        g, pred, aff, conf, dep, saved = args
        n0 = prop_loop_bwd.launches
        outs = prop_loop_bwd(*args, **kw)
        n = prop_loop_bwd.launches - n0
        fn = lambda: prop_loop_bwd(*args, **kw)
        plain = lambda: prop_loop_bwd_plain(g, pred, aff, conf, dep, **kw)
        tile, chunks = loop_plan(steps, kernel, (b, h, w), sms, backward=True,
                                 clip=kw["clip"])
        if n != len(chunks):
            raise AssertionError(f"prop_loop_bwd: {n} launches, the plan has {len(chunks)}")
        if (h, w, kernel, steps, ties) == (REQ_H, REQ_W, 3, 12, False):
            log(f"[kernel] prop_loop_bwd B={b}: 12 x K1b prop_step_bwd on the same "
                f"inputs {time_ms(library):.4f} ms")
            # per step and pixel: d_aff 3 and d_p 2 a tap, 5 more
            check_bwd("prop_loop_bwd", b, fn, plain, 1e-5, None,
                      bound(nbytes(g, aff, conf, dep, saved, *outs),
                            b * h * w * steps * (5 * kernel * kernel + 5)))
            return
        _, rel = grads_err(outs, plain())
        tag = (f"prop_loop_bwd {kernel}x{kernel} {steps} steps B={b} {h}x{w}"
               f"{' clip ties, pre-blend' if ties else ''}")
        if not rel <= 1e-5 or not same_bits(fn):
            raise AssertionError(f"{tag}: rel {rel:.3e} or other bits")
        zeros = (f", {int((prop_loop_plain(pred, aff, conf, dep, **kw) == 0).sum())} "
                 f"zero outputs" if ties else "")
        log(f"[kernel] {tag}: {n} launch(es) of {tile}x{tile} tiles{zeros}, "
            f"rel {rel:.3e}, equal bits in two runs")

    def check_k1b(b, h, w, kernel=3, clip=False):
        """K1b (the local step's backward) against its plain version on
        prop_step_bwd_case's inputs, twice for equal bits, timed beside its
        yardstick (autograd's backward of the unfold form); with ``clip``
        (an all-zero corner: the ties) both with the forward's output, as
        PropStepFunction saves it, and without, the step recomputed at
        every pixel."""
        args, kw, library = prop_step_bwd_case(gen, dev, b, h, w, kernel, clip)
        outs = prop_step_bwd(*args, **kw)
        shape = ("" if (h, w, kernel, clip) == (REQ_H, REQ_W, 3, False)
                 else f" {h}x{w} {kernel}x{kernel}{' clip' if clip else ''}")
        # the function's own planes (the saved output is a hint, not an input);
        # per pixel: d_aff 1 a tap, d_p 2 a tap, ga and the two products 4
        check_bwd("prop_step_bwd", b, lambda: prop_step_bwd(*args, **kw),
                  lambda: prop_step_bwd_plain(*args, **kw), 1e-5, library,
                  bound(nbytes(*args, *outs), b * h * w * (3 * kernel ** 2 + 4)),
                  shape=shape)
        if clip:
            kw_all = {k: v for k, v in kw.items() if k != "out"}
            fn = lambda: prop_step_bwd(*args, **kw_all)
            _, rel = grads_err(fn(), prop_step_bwd_plain(*args, **kw_all))
            if not rel <= 1e-5 or not same_bits(fn):
                raise AssertionError(f"prop_step_bwd B={b}{shape} without the output: "
                                     f"rel {rel:.3e} or other bits")
            log(f"[kernel] prop_step_bwd B={b}{shape}: {int((kw['out'] == 0).sum())} "
                f"zero outputs (the ties); without the saved output (the step "
                f"recomputed at every pixel) rel {rel:.3e}, equal bits in two runs")

    def check_k4(b, hg, wg, k, c=256):
        """K4 (decode_aff tail backward) against its plain version on a base
        grid hg x wg x c with K = k output channels."""
        args, library = decode_aff_tail_bwd_case(gen, dev, b, hg, wg, k, c)
        outs = decode_aff_tail_bwd(*args)
        flops = 2 * 2 * b * (taps_t2(hg) * taps_t2(wg) * c * 16
                             + taps_t2(2 * hg) * taps_t2(2 * wg) * 16 * k)
        shape = ("" if (hg, wg, k, c) == (58, 76, 8, 256)
                 else f" {hg}x{wg} K={k} C={c}")
        check_bwd("decode_aff_tail_bwd", b, lambda: decode_aff_tail_bwd(*args),
                  lambda: decode_aff_tail_bwd_plain(*args), 1e-4, library,
                  bound(nbytes(*args, *outs), flops), shape=shape)

    def check_k5(b, h, w, c=256):
        """K5 (encode_dep front backward) against its plain version on an
        h x w plane -> ceil(ceil(h/2)/2) x ceil(ceil(w/2)/2) x c."""
        args, library = dep_encode_front_bwd_case(gen, dev, b, h, w, c)
        outs = dep_encode_front_bwd(*args)
        conv0_pairs = taps_s2(h) * taps_s2(w) * 16
        conv1_pairs = taps_s2((h + 1) // 2) * taps_s2((w + 1) // 2) * 16 * c
        # dx, dW0 and the recomputed conv0; dP0 and dW1
        flops = 2 * b * (3 * conv0_pairs + 2 * conv1_pairs)
        shape = "" if (h, w, c) == (REQ_H, REQ_W, 256) else f" {h}x{w} C={c}"
        check_bwd("dep_encode_front_bwd", b, lambda: dep_encode_front_bwd(*args),
                  lambda: dep_encode_front_bwd_plain(*args), 1e-4, library,
                  bound(nbytes(*args, *outs), flops), shape=shape)

    for b in (TRAIN_B, 1):
        # K1b: the fork default's step (3x3, conf, preserve, no clip)
        check_k1b(b, REQ_H, REQ_W)
        if b == 1:  # the clip's ties (an all-zero corner) and the 5x5 kernel
            for kernel in (3, 5):
                check_k1b(b, REQ_H, REQ_W, kernel, clip=True)

        check_k4(b, 58, 76, 8)
        check_k5(b, REQ_H, REQ_W)

        # K8: the offset step's backward, offsets clamped to the window
        g, pred, off, aff, conf, dep = check_k8(b, REQ_H, REQ_W)
        kw = dict(kernel=3, radius=RADIUS, preserve=True, clip=False)
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

        # K6b: the loop's backward as the model calls it, from K6's saved
        # step inputs; beside it 12 launches of K1b on the same inputs
        check_k6b(b, REQ_H, REQ_W)
        if b == 1:  # the clip's ties (an all-zero corner), with the pre-blend; 5x5
            check_k6b(b, REQ_H, REQ_W, ties=True)
            check_k6b(b, REQ_H, REQ_W, kernel=5, ties=True)
            # 18 steps (one launch at b=1) and 100 (launches of fewer
            # steps, each adding to the sums)
            check_k6b(b, REQ_H, REQ_W, steps=18)
            check_k6b(b, REQ_H, REQ_W, steps=100)

    # K1b with the clip on at the train batch, on a plane whose sides are
    # no multiple of its tiles, and at KITTI's width
    check_k1b(TRAIN_B, REQ_H, REQ_W, clip=True)
    check_k1b(TRAIN_B, 230, 306)
    check_k1b(1, KITTI_H, KITTI_W)

    # K6b on a plane whose sides are not multiples of its tiles, and 18
    # steps at the train batch (two launches of 32x32 tiles)
    check_k6b(TRAIN_B, 230, 306)
    check_k6b(TRAIN_B, REQ_H, REQ_W, steps=18)

    # K6b's every branch: each combination of preserve, clip, pre_blend and
    # conf (dep is read with preserve or pre_blend), on the clip's ties, at
    # 12 steps (one launch) and 30 (three, each adding to the sums)
    (g, pred, aff, conf, dep, _), _, _ = prop_loop_bwd_case(gen, dev, 1, REQ_H, REQ_W,
                                                            ties=True)
    for preserve, clip, pre_blend, c, steps in itertools.product(
            (False, True), (False, True), (False, True), (conf, None), (12, 30)):
        kw = dict(steps=steps, kernel=3, preserve=preserve, clip=clip, pre_blend=pre_blend)
        sv = launch_loop(pred, aff, c, dep, save=True, **kw)[1]
        fn = lambda: prop_loop_bwd(g, pred, aff, c, dep, sv, **kw)
        _, rel = grads_err(fn(), prop_loop_bwd_plain(g, pred, aff, c, dep, **kw))
        if not rel <= 1e-5 or not same_bits(fn):
            raise AssertionError(f"prop_loop_bwd {kw} conf={c is not None}: rel "
                                 f"{rel:.3e} or other bits")
    log("[kernel] prop_loop_bwd: all 32 combinations of preserve, clip, pre_blend, "
        "conf and 12 or 30 steps within 1e-5 of the plain version, equal bits in "
        "two runs")

    # K4 and K5 at the shapes their tiles make risky: K4 with K = 24 (5x5
    # propagation), K5 on a plane whose sides are not multiples of 4, K5 at
    # KITTI's 240x1216 and K4 on its 60x304 base grid; K4 on an odd base
    # width (dy1's rows not 16-byte aligned), and both with C = 30 (channels
    # not in 16-byte groups: the 4-byte copies)
    check_k4(1, 58, 76, 24)
    check_k5(2, 230, 306)
    check_k5(1, KITTI_H, KITTI_W)
    check_k4(1, KITTI_H // 4, KITTI_W // 4, 8)
    check_k4(1, 58, 75, 8)
    check_k4(1, 58, 76, 8, c=30)
    check_k5(1, REQ_H, REQ_W, c=30)

    # K8 where its binned gather is risky: 5x5 neighbours, windows R 1 and
    # 8, a plane whose sides are not multiples of its 32x8 tiles, KITTI's
    # width, and converging offsets (its largest bins) at the train batch
    check_k8(1, REQ_H, REQ_W, kernel=5)
    check_k8(1, REQ_H, REQ_W, radius=1)
    check_k8(1, REQ_H, REQ_W, radius=8)
    check_k8(1, 230, 306)
    check_k8(1, KITTI_H, KITTI_W)
    check_k8(TRAIN_B, REQ_H, REQ_W, converge=True)

    # ---- 5. and 6. serving ----
    fwd_wrappers = {"prop_step": prop_step, "deform_prop": deform_prop,
                    "prop_loop": prop_loop,
                    "decode_aff_tail": decode_aff_tail,
                    "dep_encode_front": dep_encode_front}
    bwd_wrappers = {"prop_step_bwd": prop_step_bwd,
                    "deform_prop_bwd": deform_prop_bwd,
                    "prop_loop_bwd": prop_loop_bwd,
                    "decode_aff_tail_bwd": decode_aff_tail_bwd,
                    "dep_encode_front_bwd": dep_encode_front_bwd}
    plain_of = {"prop_step": prop_step_plain, "deform_prop": deform_prop_plain,
                "prop_loop": prop_loop_plain,
                "decode_aff_tail": decode_aff_tail_plain,
                "dep_encode_front": dep_encode_front_plain}

    def expected_launches(cfg, wrappers):
        """Launches a forward (and a backward) of ``cfg`` makes on the
        serving and training paths (need_inter=False): on the whole-loop
        route one prop_loop (and one prop_loop_bwd, the count its 3x3
        12-step loop takes) and nothing else; otherwise the step kernel of
        its propagation prop_time times, the GRU's two prop_time - 1 times,
        the other step kernels never."""
        if nlspn_mod.uses_loop_kernel(cfg, need_inter=False):
            return {k: int(k in ("prop_loop", "prop_loop_bwd")) for k in wrappers}
        step = "deform_prop" if cfg.offset else "prop_step"
        return {k: (cfg.prop_time if k in (step, step + "_bwd")
                    else 0 if k.startswith(("prop_step", "deform_prop", "prop_loop"))
                    else cfg.prop_time - 1) for k in wrappers}

    def with_plain_versions(fn, plain=plain_of):
        """fn() with the model calling every kernel's plain version."""
        saved = {k: getattr(nlspn_mod, k) for k in plain}
        try:
            for k, f in plain.items():
                setattr(nlspn_mod, k, f)
            return fn()
        finally:
            for k, f in saved.items():
                setattr(nlspn_mod, k, f)

    def serve(cfg, tag):
        """4 single requests and one batch of 4 through a Predictor with
        random weights; launch counts, outputs, the whole forward against
        the plain versions, latency and forward time. Returns the counts."""
        weights = randomize_(get_model(cfg, dev), torch.Generator().manual_seed(1))
        predictor = Predictor(cfg, state_dict=weights.state_dict(), device=dev)
        del weights
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

        # the whole forward through the kernels vs the same with plain
        # versions (with the per-step outputs, except on the whole-loop route)
        sample, _ = predictor.make_sample([r for r, _ in batches[-1]],
                                          [d for _, d in batches[-1]])
        need_inter = not nlspn_mod.uses_loop_kernel(cfg, need_inter=False)
        with torch.inference_mode():
            out_k = predictor.model(sample, need_inter=need_inter)
            out_p = with_plain_versions(lambda: predictor.model(sample,
                                                                need_inter=need_inter))
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
    loop_launches = serve(Config(**LOOP), " loop")
    torch.cuda.empty_cache()

    # ---- 7. and 8. training ----
    step_medians = {}

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

        def worst_of(got, want):
            return max(((got[n] - want[n]).norm().item()
                        / max(want[n].norm().item(), 1e-30), n) for n in want)

        # cuDNN's deterministic algorithms, picked by its heuristics, for
        # this comparison: benchmark mode picks by timing, so another run may
        # pick others, among them ones that sum with atomic adds, whose
        # run-to-run noise is not the kernels' (one run of the loop model
        # read 9.0e-3 on conv4.0.conv1.weight's gradient with them, and one
        # with timed deterministic picks 2.3e-3 on the default's
        # encode_dep.0.0.weight); the kernels' path runs twice, its own
        # difference printed as the comparison's floor
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                         allow_tf32=False):
            loss_k, grads_k = loss_and_grads()
            _, grads_k2 = loss_and_grads()
            loss_p, grads_p = with_plain_versions(loss_and_grads)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        worst = worst_of(grads_k, grads_p)
        floor = worst_of(grads_k2, grads_k)
        log(f"[train{tag}] one step, kernels vs plain: loss {loss_k:.6f} vs "
            f"{loss_p:.6f} (rel {rel:.3e}); worst gradient {worst[1]} rel "
            f"{worst[0]:.3e} (kernels against themselves: {floor[0]:.3e}, "
            f"{floor[1]}; cuDNN deterministic, by its heuristics)")
        if not rel <= 1e-4:
            raise AssertionError(f"train step loss: rel {rel:.3e} > 1e-4")
        if not worst[0] <= 5e-3:
            raise AssertionError(f"train step gradient {worst[1]}: rel {worst[0]:.3e}")
        del grads_k, grads_k2, grads_p

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
        step_medians[tag] = sorted(step_ms)[len(step_ms) // 2]
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

    def train_window_0():
        """One Engine step of Config(offset=True, offset_window=0) at batch
        2 of 228x304 (the exact gather at unclamped offsets, its backward
        the exact gather's plain VJP): launches, a finite loss, a finite
        gradient for every parameter; then the median of 5 timed steps.
        That backward is autograd's through ``torch.gather``, which
        scatters with atomic adds on the card: d_pred and d_conf may differ
        in the last bits from run to run (the JAX package's is
        deterministic). So the first step runs twice from the same
        parameters on the same batch, and every parameter gradient is held
        within the train bar (5e-3 relative) of the first run's, not to
        equal bits."""
        cfg = Config(offset=True, offset_window=0, batch_size=2)
        eng = Engine(cfg, steps_per_epoch=100, device=dev)
        randomize_(eng.model, torch.Generator().manual_seed(6))
        model = eng.init_state()
        start_state = {k: v.clone() for k, v in model.state_dict().items()}
        data = Synthetic(cfg, "train")
        drng = np.random.default_rng(7)
        wbatches = [eng.put_batch(data.batch([2 * i, 2 * i + 1], drng)) for i in range(6)]
        wrappers = {**fwd_wrappers, **bwd_wrappers}
        per_step = dict(expected_launches(cfg, wrappers), deform_prop_bwd=0)
        for fn in wrappers.values():
            fn.launches = 0
        aux = eng.train_step(wbatches[0])
        counts = {k: fn.launches for k, fn in wrappers.items()}
        if counts != per_step:
            raise AssertionError(f"window 0: launches {counts}, expected {per_step}")
        if not np.isfinite(aux["loss"].item()):
            raise AssertionError(f"window 0: loss {aux['loss'].item()}")
        for pname, p in model.named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"window 0: {pname} has no finite gradient")
        first = {n: p.grad.clone() for n, p in model.named_parameters()}
        eng.init_state(start_state)   # the same parameters, a fresh Adam
        eng.train_step(wbatches[0])
        again = {n: p.grad for n, p in model.named_parameters()}
        worst = max(((first[n] - again[n]).norm().item()
                     / max(first[n].norm().item(), 1e-30), n) for n in first)
        max_abs = max((first[n] - again[n]).abs().max().item() for n in first)
        n_other = sum(not torch.equal(first[n], again[n]) for n in first)
        n_params = len(first)
        if not worst[0] <= 5e-3:
            raise AssertionError(f"window 0: the step's two runs differ, gradient "
                                 f"{worst[1]} rel {worst[0]:.3e} > 5e-3")
        del first, again, start_state
        step_ms = []
        for batch in wbatches[1:]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng.train_step(batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        log(f"[train offset window 0] one step of 2 x {REQ_H}x{REQ_W}: loss "
            f"{aux['loss'].item():.4f}, finite; every parameter got a finite "
            f"gradient; launches {counts}; max |offset| {aux['off_max'].item():.3f}; "
            f"step (CUDA events) median {sorted(step_ms)[2]:.3f} ms of 5")
        log(f"[train offset window 0] its backward is autograd's through "
            f"torch.gather, a scatter with atomic adds (not deterministic): the "
            f"first step run twice from the same parameters, largest gradient "
            f"difference {worst[1]} rel {worst[0]:.3e} (max abs {max_abs:.3e}; "
            f"{n_other} of {n_params} parameters not equal bits), within 5e-3")

    train_launches = train(Config(), "")
    torch.cuda.empty_cache()
    offset_train_launches = train(Config(offset=True), " offset")
    torch.cuda.empty_cache()
    train_window_0()
    torch.cuda.empty_cache()
    loop_train_launches = train(Config(**LOOP), " loop")

    torch.cuda.empty_cache()

    # ---- 10. the op library ----
    t_oplib = time.perf_counter()
    CA, CB = 3 * nlspn_mod.NLSPNModel.HEAD_WIDTH, 64   # the heads' stage 2

    def conv_flops(b, h, w, c, k):
        return 2 * b * h * w * c * 9 * k

    def k9b_bound(nb, flops):
        """K9's and K9b's bound for their design, the larger of their bytes'
        and of their three TF32 passes' on the tensor cores; and their f32
        FMA bound."""
        t_tc = 3 * flops / (peak["tf32_tflops"] * 1e12) * 1e3
        t_bytes = bound(nb, 0)[0]
        return ((t_tc, "operations") if t_tc >= t_bytes else (t_bytes, "bytes"),
                bound(nb, flops))

    for b, h, w, k in ((1, H, W, 10), (4, H, W, 10), (TRAIN_B, REQ_H, REQ_W, 10),
                       (2, 57, 75, 26)):
        xa, xb = randn(b, CA, h, w), randn(b, CB, h, w)
        wk, bk = randn(k, CA + CB, 3, 3, std=(9 * (CA + CB)) ** -0.5), randn(k, std=0.1)
        out = small_conv3x3_planar(xa, xb, wk, bk)
        if not torch.equal(out, small_conv3x3_planar(xa, xb, wk, bk)):
            raise AssertionError(f"small_conv3x3 B={b} {h}x{w} K={k}: two runs, other bits")
        # held against the plain version in float64: cuDNN's f32 backward
        # of this conv is itself ~1e-4 off at these sums (the forward's log
        # line shows how far its f32 forward is)
        ref = small_conv3x3_plain(*(t.double() for t in (xa, xb, wk, bk)))
        torch.cuda.synchronize()
        err, rel = rel_err(out.double(), ref)
        log(f"[kernel] small_conv3x3 B={b}: plain f32 vs float64 rel "
            f"{rel_err(small_conv3x3_plain(xa, xb, wk, bk).double(), ref)[1]:.3e}; "
            f"equal bits in two runs")
        del ref
        ms = time_ms(lambda: small_conv3x3_planar(xa, xb, wk, bk))
        plain_ms = time_ms(lambda: small_conv3x3_plain(xa, xb, wk, bk))
        bnd, fma = k9b_bound(nbytes(xa, xb, wk, bk, out), conv_flops(b, h, w, CA + CB, k))
        log(f"[kernel] small_conv3x3 B={b} {h}x{w} K={k}: bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"3 TF32 passes on the tensor cores, {peak['tf32_tflops']} TFLOP/s), "
            f"f32 FMA bound {fma[0]:.4f} ms")
        # the library call is the plain version itself: F.conv2d over the concat
        record("small_conv3x3", b, err, rel, 1e-4, ms, plain_ms, plain_ms, bnd)

    # the train step's plane at B=12 and B=1 (K 10, the kernel line's), then
    # B=2 of an odd 57x75 plane with the offset heads' K 26 and K 1
    for b, h, w, k in ((TRAIN_B, REQ_H, REQ_W, 10), (1, REQ_H, REQ_W, 10), (2, 57, 75, 26),
                       (1, REQ_H, REQ_W, 1)):
        xa, xb = randn(b, CA, h, w), randn(b, CB, h, w)
        wk = randn(k, CA + CB, 3, 3, std=(9 * (CA + CB)) ** -0.5)
        g = randn(b, k, h, w)
        outs = small_conv3x3_bwd(g, xa, xb, wk)
        xcat = torch.cat([xa, xb], 1)

        def library():
            """cuDNN's backward of the concat conv (autograd's, whose cat
            backward is two views)."""
            dx, dw, db = conv_bwd(g, xcat, wk, [k], [1, 1], [1, 1], [1, 1], False,
                                  [0, 0], 1, [True, True, True])
            return dx[:, :CA], dx[:, CA:], dw, db

        def plain64():
            return [t.float() for t in small_conv3x3_bwd_plain(
                *(t.double() for t in (g, xa, xb, wk)))]

        shape = "" if (h, w, k) == (REQ_H, REQ_W, 10) else f" {h}x{w} K={k}"
        _, rel32 = grads_err(small_conv3x3_bwd_plain(g, xa, xb, wk), plain64())
        log(f"[kernel] small_conv3x3_bwd B={b}{shape}: plain f32 vs float64 rel {rel32:.3e}")
        bnd, fma = k9b_bound(nbytes(g, xa, xb, wk, *outs),
                             2 * conv_flops(b, h, w, CA + CB, k) + b * h * w * k)
        log(f"[kernel] small_conv3x3_bwd B={b}{shape}: bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"3 TF32 passes on the tensor cores, {peak['tf32_tflops']} TFLOP/s), "
            f"f32 FMA bound {fma[0]:.4f} ms")
        check_bwd("small_conv3x3_bwd", b,
                  lambda: small_conv3x3_bwd(g, xa, xb, wk),
                  lambda: small_conv3x3_bwd_plain(g, xa, xb, wk),
                  1e-4, library, bnd, ref=plain64, shape=shape)
        del xa, xb, xcat, outs
    torch.cuda.empty_cache()

    # K9-bf16 and K9b-bf16 (the TPU kernels at dt = bfloat16) against their
    # plain versions, which round as the TPU kernels do: the forward each
    # tap's f32 sum before the taps are added, the backward dx once. One ulp
    # cannot tell a forward that rounds once from one that rounds per tap
    # (one rounding puts ~40% of the outputs an ulp off), so the share of
    # outputs not bit-equal is held too
    bf16 = torch.bfloat16
    ulp = 2.0 ** -7           # one bf16 ulp, relative to the largest plain output
    fwd_share_bar = 1e-2
    for b, h, w, k in ((1, H, W, 10), (4, H, W, 10), (TRAIN_B, REQ_H, REQ_W, 10),
                       (2, 57, 75, 26)):
        shape = "" if (h, w, k) == (H, W, 10) else f" {h}x{w} K={k}"
        args, library = small_conv3x3_case(gen, dev, b, h, w, k, CA, CB, dtype=bf16)
        plan = fwd_plan_bf16(b, h, w, CA, CB, k)
        card_plan = fwd_plan_bf16_card(b, h, w, CA, CB, k)
        if any(card_plan[key] != plan[key] for key in card_plan):
            raise AssertionError(f"small_conv3x3_bf16 B={b}{shape}: the source's plan "
                                 f"{card_plan}, its mirror's {plan}")
        out, ref = small_conv3x3_bf16(*args), small_conv3x3_plain_bf16(*args)
        torch.cuda.synchronize()
        if not same_bits(lambda: small_conv3x3_bf16(*args)):
            raise AssertionError(f"small_conv3x3_bf16 B={b}{shape}: two runs, other bits")
        err, rel = rel_err(out.float(), ref.float())
        share = (out != ref).float().mean().item()
        log(f"[kernel] small_conv3x3_bf16 B={b}{shape}: equal bits in two runs; {share:.3e} "
            f"of the outputs not bit-equal to the plain version (per-tap rounding; bar "
            f"{fwd_share_bar:.0e}); its plan {card_plan} equal to fwd_plan_bf16's")
        if not share <= fwd_share_bar:
            raise AssertionError(f"small_conv3x3_bf16 B={b}{shape}: {share:.3e} of the outputs "
                                 f"not bit-equal > {fwd_share_bar:.0e}")
        record("small_conv3x3_bf16", b, err, rel, ulp,
               time_ms(lambda: small_conv3x3_bf16(*args)),
               time_ms(lambda: small_conv3x3_plain_bf16(*args)), time_ms(library),
               bound(nbytes(*args, out), conv_flops(b, h, w, CA + CB, k), "bf16_tflops"),
               shape=shape)
        del args, out, ref
    for b, h, w, k in ((TRAIN_B, REQ_H, REQ_W, 10), (1, REQ_H, REQ_W, 10), (2, 57, 75, 26),
                       (2, 57, 76, 26)):
        shape = "" if (h, w, k) == (REQ_H, REQ_W, 10) else f" {h}x{w} K={k}"
        tag = f"small_conv3x3_bwd_bf16 B={b}{shape}"
        plan, card_plan = bwd_plan_bf16(b, h, w, CA, CB, k), bwd_plan_bf16_card(b, h, w, CA, CB, k)
        if any(card_plan[key] != plan[key] for key in card_plan):
            raise AssertionError(f"{tag}: the source's plan {card_plan}, its mirror's {plan}")
        log(f"[kernel] {tag}: its plan {card_plan} equal to bwd_plan_bf16's")
        args, library = small_conv3x3_bwd_case(gen, dev, b, h, w, k, CA, CB, dtype=bf16)
        outs, refs = small_conv3x3_bwd_bf16(*args), small_conv3x3_bwd_plain_bf16(*args)
        torch.cuda.synchronize()
        if not same_bits(lambda: small_conv3x3_bwd_bf16(*args)):
            raise AssertionError(f"{tag}: two runs gave other bits")
        errs = [rel_err(o.float(), r.float()) for o, r in zip(outs, refs)]
        share = max((o != r).float().mean().item() for o, r in zip(outs[:2], refs[:2]))
        log(f"[kernel] {tag}: equal bits in two runs; relative error of dxa, dxb, dw, db "
            f"{[f'{r:.2e}' for _, r in errs]} (bars 2^-7, 2^-7, 5e-4, 5e-4); {share:.3e} of "
            f"dx not bit-equal to the plain version (bar 1e-3)")
        if not share <= 1e-3 or not errs[1][1] <= ulp:
            raise AssertionError(f"{tag}: dx {share:.3e} not bit-equal, dxb rel {errs[1][1]:.3e}")
        for name, (_, r) in zip(("dw", "db"), errs[2:]):
            if not r <= 5e-4:
                raise AssertionError(f"{tag}: {name} relative error {r:.3e} > 5e-4")
        bnd = bound(nbytes(*args, *outs), 2 * conv_flops(b, h, w, CA + CB, k), "bf16_tflops")
        if plan["copied"]:   # x and g copied into rows of a multiple of 8 columns, read again
            copy_bytes = 2 * b * (CA + CB + k) * h * plan["pitch"] * 2
            log(f"[kernel] {tag}: its copy of x and g moves {copy_bytes / 1e6:.2f} MB more; "
                f"the bound with it {bnd[0] + copy_bytes / (peak['hbm_tbps'] * 1e9):.4f} ms")
        record("small_conv3x3_bwd_bf16", b, max(e for e, _ in errs), errs[0][1], ulp,
               time_ms(lambda: small_conv3x3_bwd_bf16(*args)),
               time_ms(lambda: small_conv3x3_bwd_plain_bf16(*args)), time_ms(library), bnd,
               main_b=TRAIN_B, shape=shape)
        del args, outs, refs
    torch.cuda.empty_cache()

    def check_close(tag, got, want, tol):
        err, rel = rel_err(got, want)
        if not rel <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"{tag}: relative error {rel:.3e} > {tol:.0e}")
        log(f"[oplib] {tag}: max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:.0e})")

    def heads_identity(cfg, tag):
        """K9 over a b=1 request's stage-1 outputs and fe1, with the fused
        stage-2 weights, against the model's three *_dec0 convs."""
        weights = randomize_(get_model(cfg, dev), torch.Generator().manual_seed(8))
        predictor = Predictor(cfg, state_dict=weights.state_dict(), device=dev)
        del weights
        model = predictor.model
        seen = {}
        names = [n for n, _ in model.head_specs]
        hooks = [getattr(model, f"{n}_dec0").register_forward_hook(
            lambda mod, inp, out, n=n: seen.__setitem__(n, (inp[0], out)))
            for n in names]
        rng = np.random.default_rng(9)
        dep = np.zeros((REQ_H, REQ_W), np.float32)
        dep.flat[rng.choice(REQ_H * REQ_W, cfg.num_sample, replace=False)] = \
            rng.uniform(0.5, 10.0, cfg.num_sample)
        sample, _ = predictor.make_sample(
            [rng.integers(0, 256, (REQ_H, REQ_W, 3), dtype=np.uint8)], [dep])
        width = model.HEAD_WIDTH
        with torch.inference_mode():
            model(sample, need_inter=False)
            for hk in hooks:
                hk.remove()
            xa = torch.cat([seen[n][0][:, :width] for n in names], 1).contiguous()
            xb = seen[names[0]][0][:, width:].contiguous()
            wk, bk = fuse_heads_dec0([(getattr(model, f"{n}_dec0")[0].weight,
                                       getattr(model, f"{n}_dec0")[0].bias)
                                      for n in names], width)
            out = small_conv3x3_planar(xa, xb, wk.contiguous(), bk.contiguous())
            ref = torch.cat([seen[n][1] for n in names], 1)
            # the same *_dec0 convs in float64, as K9 is held above
            ref64 = torch.cat([F.conv2d(seen[n][0].double(), m[0].weight.double(),
                                        m[0].bias.double(), padding=1)
                               for n in names for m in [getattr(model, f"{n}_dec0")]], 1)
        log(f"[oplib] heads identity{tag}: K9 vs the model's f32 *_dec0 outputs rel "
            f"{rel_err(out, ref)[1]:.3e}")
        check_close(f"heads identity{tag}: K9 (K={wk.shape[0]}) on {tuple(xa.shape)} "
                    f"+ fe1 {tuple(xb.shape)} vs the *_dec0 convs in float64",
                    out.double(), ref64, 1e-4)

    def module_on_card_and_cpu(tag, mod, inputs):
        """Forward and backward of ``mod`` on the card against the same
        module (same state_dict) on the CPU."""
        cpu_mod = copy.deepcopy(mod).cpu()
        mod = mod.to(dev)
        xin = [t.detach().to(dev).requires_grad_(i == 0) for i, t in enumerate(inputs)]
        cin = [t.detach().clone().requires_grad_(i == 0) for i, t in enumerate(inputs)]
        out, out_c = mod(*xin), cpu_mod(*cin)
        g = torch.randn(out.shape, generator=gen)
        out.backward(g.to(dev))
        out_c.backward(g)
        torch.cuda.synchronize()
        check_close(f"{tag} forward, card vs CPU", out, out_c.to(dev), 1e-4)
        check_close(f"{tag} d_input", xin[0].grad, cin[0].grad.to(dev), 1e-4)
        for (pname, p), (_, pc) in zip(mod.named_parameters(), cpu_mod.named_parameters()):
            check_close(f"{tag} d_{pname}", p.grad, pc.grad.to(dev), 1e-4)

    def op_library():
        """The op library's path on the card; returns the K9 counts."""
        for fn in (small_conv3x3_planar, small_conv3x3_bwd, small_conv3x3_bf16,
                   small_conv3x3_bwd_bf16):
            fn.launches = 0
        heads_identity(Config(), "")
        heads_identity(Config(offset=True), " offset")
        # one autograd step through the op (K9 forward, K9b backward)
        leaves = [randn(2, CA, 57, 76), randn(2, CB, 57, 76),
                  randn(26, CA + CB, 3, 3, std=(9 * (CA + CB)) ** -0.5),
                  randn(26, std=0.1)]
        leaves = [t.requires_grad_(True) for t in leaves]
        g = randn(2, 26, 57, 76)
        small_conv3x3_planar(*leaves).backward(g)
        want = small_conv3x3_bwd_plain(g, *[t.detach() for t in leaves[:3]])
        for name, leaf, ref in zip(("dxa", "dxb", "dw", "db"), leaves, want):
            check_close(f"small_conv3x3_planar autograd {name}", leaf.grad, ref, 1e-4)
        # and one in bf16 (K9-bf16 forward, K9b-bf16 backward): bf16
        # activations, f32 parameters as the port's bf16 models keep them
        leaves16 = [t.detach().to(dt).requires_grad_(True)
                    for t, dt in zip(leaves, (bf16, bf16, torch.float32, torch.float32))]
        out16 = small_conv3x3_planar(*leaves16)
        if out16.dtype != bf16:
            raise AssertionError(f"small_conv3x3_planar on bf16: a {out16.dtype} output")
        out16.backward(g.to(bf16))
        want16 = small_conv3x3_bwd_plain_bf16(g, *[t.detach() for t in leaves16[:3]])
        for name, leaf, ref in zip(("dxa", "dxb", "dw", "db"), leaves16, want16):
            if leaf.grad.dtype != leaf.dtype:
                raise AssertionError(f"bf16 autograd {name}: {leaf.grad.dtype} gradient")
            check_close(f"small_conv3x3_planar bf16 autograd {name}", leaf.grad.float(),
                        ref.float(), ulp if name.startswith("dx") else 5e-4)
        counts = {"small_conv3x3": small_conv3x3_planar.launches,
                  "small_conv3x3_bwd": small_conv3x3_bwd.launches,
                  "small_conv3x3_bf16": small_conv3x3_bf16.launches,
                  "small_conv3x3_bwd_bf16": small_conv3x3_bwd_bf16.launches}
        log(f"[oplib] K9 launches on the op-library path: {counts}")
        for k, n in counts.items():
            if n == 0:
                raise AssertionError(f"{k} was not launched on the op-library path")

        # the DCN modules with offsets and masks made non-trivial: integer +
        # 0.5 biases and small weights keep every offset within 0.3 of a
        # half, where the card's and the CPU's floors cannot differ
        mgen = torch.Generator().manual_seed(10)
        x = torch.randn(4, 64, 57, 76, generator=mgen)
        for cls, gen_name in ((oplib.ModulatedDeformConvPack, "conv_offset_mask"),
                              (oplib.DeformConvPack, "conv_offset")):
            mod = cls(64, 64, generator=mgen)
            with torch.no_grad():
                conv = getattr(mod, gen_name)
                conv.weight.normal_(0.0, 0.002, generator=mgen)
                conv.bias.copy_(torch.randint(-2, 3, conv.bias.shape, generator=mgen) + 0.5)
                mod.bias.normal_(0.0, 0.1, generator=mgen)
            module_on_card_and_cpu(f"{cls.__name__}(64, 64) on {tuple(x.shape)}", mod, [x])
        data = torch.randn(2, 8 * 49, 57, 76, generator=mgen)
        lo = torch.rand(16, 2, generator=mgen) * torch.tensor([200.0, 150.0])
        size = 16 + torch.rand(16, 2, generator=mgen) * 80
        rois = torch.cat([torch.arange(16).remainder(2).float()[:, None], lo, lo + size], 1)
        pool = oplib.DeformRoIPoolingPack(0.25, 7, 8, group_size=7, trans_std=0.1,
                                          generator=mgen)
        with torch.no_grad():
            pool.fc_offset.weight.normal_(0.0, 0.05, generator=mgen)
        module_on_card_and_cpu(f"DeformRoIPoolingPack on {tuple(data.shape)}, 16 rois",
                               pool, [data, rois])

        # space-to-depth convs against the strided and transposed convs
        # (float64, as above)
        xs, w3 = randn(4, 64, 58, 76), randn(32, 64, 3, 3, std=1 / 24)
        check_close("conv3x3_s2 vs F.conv2d", spaceconv.conv3x3_s2(xs, w3).double(),
                    F.conv2d(xs.double(), w3.double(), None, 2, 1), 1e-4)
        xt, wt = randn(4, 64, 29, 38), randn(64, 32, 3, 3, std=1 / 12)
        check_close("convt3x3_s2 vs F.conv_transpose2d",
                    spaceconv.convt3x3_s2(xt, wt).double(),
                    F.conv_transpose2d(xt.double(), wt.double(), None, 2, 1, 1), 1e-4)

        # propagate_step(impl="pallas"): one K1, one K7
        feat = rand(2, 1, H, W, hi=10.0)
        aff = normalize_affinity(randn(2, 8, H, W),
                                        torch.full((1,), 4.0, device=dev)).contiguous()
        off = randn(2, 18, H, W, std=1.5)
        for offset, fn in ((None, prop_step), (off, deform_prop)):
            n0 = fn.launches
            got = oplib.propagate_step(feat, aff, offset, impl="pallas")
            if fn.launches - n0 != 1:
                raise AssertionError(f"propagate_step(impl='pallas'): "
                                     f"{fn.launches - n0} launches of {fn.__name__}")
            check_close(f"propagate_step(impl='pallas') through {fn.__name__} "
                        f"(1 launch) vs impl='xla'", got,
                        oplib.propagate_step(feat, aff, offset, impl="xla"), 1e-5)
        # under autograd with every offset in the window, the JAX op's
        # lax.cond takes its window form: K7 forward and K8 backward, once
        # each, against impl="xla" (autograd of the plain window form)
        off_w = clamp_offsets(off, RADIUS).contiguous()
        gout = randn(2, 1, H, W)
        grads = []
        for impl in ("pallas", "xla"):
            leaves = [x.clone().requires_grad_(True) for x in (feat, off_w, aff)]
            n7, n8 = deform_prop.launches, deform_prop_bwd.launches
            out = oplib.propagate_step(leaves[0], leaves[2], leaves[1], impl=impl)
            grads.append([out] + list(torch.autograd.grad(out, leaves, gout)))
            if impl == "pallas" and (deform_prop.launches - n7, deform_prop_bwd.launches - n8) != (1, 1):
                raise AssertionError(
                    f"propagate_step(impl='pallas') under autograd: "
                    f"{deform_prop.launches - n7} K7 and {deform_prop_bwd.launches - n8} "
                    f"K8 launches, want 1 and 1")
        for name, got, want in zip(("out", "d_feat", "d_offset", "d_aff"), *grads):
            check_close(f"propagate_step(impl='pallas') under autograd, offsets in the "
                        f"window (K7 + K8, 1 launch each) vs impl='xla': {name}",
                        got, want, 1e-5)
        return counts

    oplib_launches = op_library()
    log(f"[oplib] phase 10: {time.perf_counter() - t_oplib:.1f} s")
    torch.cuda.empty_cache()

    # ---- 11. the devtools prototypes ----
    t_devtools = time.perf_counter()

    shifts5 = torch.tensor(neighbor_shifts(5), device=dev, dtype=torch.float32)

    def windowed_library(f, off, aff, shifts=shifts3):
        """K10a's and K10b's function (the exact gather inside the window)
        through F.grid_sample over the stacked grids and the weighted sum."""
        b, h, w = f.shape
        smp = F.grid_sample(f[:, None], sampling_grid(off, shifts), mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        return (smp.view(b, -1, h, w) * aff).sum(1)

    def devtools_kernels():
        """K10a, K10b and K10c against their plain versions, timed, at the
        experiments' shapes and inputs."""
        # operations a pixel, a neighbour: K10a's 2 x 2 tent cells (2 floors
        # and their 4 clamps, the 2 second cells, 4 weights of 2 operations,
        # 4 taps and 2 rows of a product and a sum each, the affinity's
        # product and sum); K10b's two tent rows
        k10a_ops = 2 + 4 + 2 + 4 * 2 + 4 * 2 + 2 * 2 + 2
        k10_flops = {"deform_windowed": 9 * k10a_ops, "deform_colgather": 9 * 2 * 8 + 18}
        for b, h, w in exp_deform3.SHAPES:
            feat, off, aff = exp_deform3.experiment_inputs(b, h, w, dev)
            f = feat[:, 0]
            exact = propagate_deformable_exact_planar(f, off, aff)
            for kname, fn, plain in (
                    ("deform_windowed", lambda: deform_windowed(f, off, aff, 3, RADIUS),
                     lambda: propagate_deformable_windowed_planar(f, off, aff, 3, RADIUS)),
                    ("deform_colgather", lambda: deform_colgather(f, off, aff, RADIUS),
                     lambda: deform_colgather_plain(f, off, aff, RADIUS))):
                out, ref = fn(), plain()
                torch.cuda.synchronize()
                err, rel = rel_err(out, ref)
                _, rel_exact = rel_err(out, exact)
                if not rel_exact <= 1e-5:
                    raise AssertionError(f"{kname} B={b} {h}x{w}: relative error "
                                         f"{rel_exact:.3e} against the exact gather")
                if not torch.equal(out, ref):
                    raise AssertionError(f"{kname} B={b} {h}x{w}: other bits than its plain "
                                         f"version")
                log(f"[devtools] {kname} B={b} {h}x{w}: equal bits, rel {rel_exact:.3e} "
                    f"against the exact gather")
                record(kname, b, err, rel, 1e-5, time_ms(fn), time_ms(plain, reps=2),
                       time_ms(lambda: windowed_library(f, off, aff)),
                       bound(nbytes(f, off, aff, out), b * h * w * k10_flops[kname]),
                       main_b=TRAIN_B)
            log(f"[devtools] B={b} {h}x{w}: K7 deform_prop on the same inputs "
                f"{time_ms(lambda: deform_prop(f, off, aff, kernel=3)):.4f} ms")
        # K10a at 5x5, b=1
        f = randn(1, REQ_H, REQ_W)
        off = (randn(1, 50, REQ_H, REQ_W, std=1.5)).clamp(-RADIUS, RADIUS).contiguous()
        aff = randn(1, 25, REQ_H, REQ_W, std=0.11)
        fn = lambda: deform_windowed(f, off, aff, 5, RADIUS)
        plain = lambda: propagate_deformable_windowed_planar(f, off, aff, 5, RADIUS)
        out, ref = fn(), plain()
        if not torch.equal(out, ref):
            raise AssertionError("deform_windowed 5x5: other bits than its plain version")
        log(f"[devtools] deform_windowed 5x5 B=1 {REQ_H}x{REQ_W}: equal bits")
        record("deform_windowed", 1, *rel_err(out, ref), 1e-5, time_ms(fn),
               time_ms(plain, reps=2), time_ms(lambda: windowed_library(f, off, aff, shifts5)),
               bound(nbytes(f, off, aff, out), REQ_H * REQ_W * 25 * k10a_ops),
               main_b=TRAIN_B, shape=f" 5x5 {REQ_H}x{REQ_W}")
        # K10c on the probe's block, its indices and negative ones
        x, idx = exp_deform2.probe_inputs(dev)
        neg = torch.randint(-300, 300, idx.shape, generator=gen, dtype=torch.int32).to(dev)
        for axis in (0, 1):
            for ind in (idx, neg):
                if not torch.equal(probe_gather(x, ind, axis), probe_gather_plain(x, ind, axis)):
                    raise AssertionError(f"gather_probe axis {axis}: other bits")
            log(f"[devtools] gather_probe (64, 128) axis {axis}: equal bits, indices "
                f"in [0, 64) and in [-300, 300)")
        ind64 = idx.long()
        probe_bound = bound(nbytes(x, idx, x), x.numel())
        record("gather_probe", 1, 0.0, 0.0, 0.0, time_ms(lambda: probe_gather(x, idx, 1)),
               time_ms(lambda: probe_gather_plain(x, idx, 1)),
               time_ms(lambda: torch.gather(x, 1, ind64)), probe_bound)
        # the launch floor: one kernel that does no work, timed as gather_probe
        one = torch.zeros(1, device=dev)
        floor_ms = time_ms(lambda: one.zero_())
        log(f"[devtools] launch floor: a one-element zero_ {floor_ms:.4f} ms a call "
            f"(CUDA-graph replay of 20 calls); gather_probe's bound with it "
            f"{max(floor_ms, probe_bound[0]):.4f} ms, its bytes {probe_bound[0]:.5f} ms")

    def devtools_path():
        """The devtools entry points with the counters at 0: K10a's
        drop-in forward and backward (K8) at b=12, offsets as drawn (inside
        the window) and spread to +-(R + 1.5) (beyond it), against the
        plain versions; exp_deform3.main() and exp_deform2.main() at their
        shapes. Returns the counts."""
        wrappers = {"deform_windowed": deform_windowed, "deform_colgather": deform_colgather,
                    "gather_probe": probe_gather, "deform_prop_bwd": deform_prop_bwd}
        for fn in wrappers.values():
            fn.launches = 0
        feat, off, aff = exp_deform3.experiment_inputs(TRAIN_B, REQ_H, REQ_W, dev)
        g = randn(TRAIN_B, 1, REQ_H, REQ_W)
        for tag, o in (("inside", off), ("beyond", (off * 1.4).clamp(
                -RADIUS - 1.5, RADIUS + 1.5).contiguous())):
            leaves = [x.clone().requires_grad_(True) for x in (feat, o, aff)]
            out = propagate_deformable_pallas(*leaves, radius=RADIUS)
            got = torch.autograd.grad(out, leaves, g)
            f = feat[:, 0]
            want = (propagate_deformable_windowed_planar(f, o, aff, 3, RADIUS),
                    *deform_prop_bwd_plain(g[:, 0], f, o, aff, None, None, kernel=3,
                                           radius=RADIUS, preserve=False, clip=False)[:3])
            errs = [rel_err(a, b)[1] for a, b in zip((out[:, 0], got[0][:, 0]) + got[1:], want)]
            if not max(errs) <= 1e-5:
                raise AssertionError(f"propagate_deformable_pallas, offsets {tag}: rel {errs}")
            log(f"[devtools] propagate_deformable_pallas B={TRAIN_B} forward and backward, "
                f"offsets {tag} the window (max |o| {o.abs().max().item():.2f}): "
                f"rel {max(errs):.3e} against the plain versions")
        r3 = exp_deform3.main(dev)
        r2 = exp_deform2.main(dev)
        for shape, r in list(r3.items()) + [(k, v) for k, v in r2.items() if k != "probe"]:
            if not r["max_err"] <= 1e-5:
                raise AssertionError(f"devtools main {shape}: max_err {r['max_err']:.3e}")
        if r2["probe"] != {0: True, 1: True}:
            raise AssertionError(f"gather probe: {r2['probe']}")
        counts = {k: fn.launches for k, fn in wrappers.items()}
        log(f"[devtools] launches on the devtools path: {counts}")
        for k, n in counts.items():
            if n == 0:
                raise AssertionError(f"{k} was not launched on the devtools path")
        return counts

    devtools_kernels()
    devtools_launches = devtools_path()
    log(f"[devtools] phase 11: {time.perf_counter() - t_devtools:.1f} s")
    torch.cuda.empty_cache()

    # ---- 12. the interleave microbenchmarks ----
    t_micro = time.perf_counter()

    def micro_kernels():
        """K11a-d against their plain versions at b=12, timed beside the
        library calls, on phases whose padding is random; K11b and K11d also
        at b=1 and on unaligned (59, 77) planes (their scalar forms), and
        K11a there too."""
        ph = randn(TRAIN_B, PHASES, *PADDED)
        e1, er = onehot_expansion(dev), randn(*E_SHAPE)
        ref = interleave_window(ph)
        # K11c's gather indices, made here: no host copy in a captured graph
        yy = torch.arange(232, device=dev).view(232, 1)
        xx = torch.arange(304, device=dev).view(1, 304)
        ch = ((yy % 4) * 4 + xx % 4) * 8 + torch.arange(8, device=dev).view(8, 1, 1)
        iy, ix = yy % 58, xx % 76

        def k11d_bound(b, out):
            """K11d's bound for its design, the larger of its bytes' and of
            its bf16 passes' on the tensor cores; and its f32 FMA bound."""
            flops = 2 * b * 4 * (8 * 58) * 304 * 304
            nb = b * PHASES * 58 * 76 * 4 + nbytes(e1) + nbytes(out)
            t_tc = len(ONEHOT_PASSES) * flops / (peak["bf16_tflops"] * 1e12) * 1e3
            t_bytes = bound(nb, 0)[0]
            tc = (t_tc, "operations") if t_tc >= t_bytes else (t_bytes, "bytes")
            return tc, bound(nb, flops)

        for kname, fn, plain, lib in (
                ("interleave_asm", lambda: interleave_asm(ph),
                 lambda: interleave_asm_plain(ph), lambda: interleave_window(ph)),
                ("interleave_strided", lambda: interleave_strided(ph),
                 lambda: interleave_strided_plain(ph), lambda: interleave_window(ph)),
                ("tile_repeat_probe", lambda: tile_repeat_probe(ph),
                 lambda: tile_repeat_probe_plain(ph), lambda: ph[:, ch, iy, ix]),
                ("interleave_onehot", lambda: interleave_onehot(ph, e1),
                 lambda: interleave_onehot_plain(ph, e1), lambda: interleave_window(ph))):
            out, want = fn(), plain()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{kname}: other bits than its plain version")
            if kname == "tile_repeat_probe":
                if not torch.equal(lib(), want):
                    raise AssertionError("tile_repeat_probe: the gather disagrees")
            elif not torch.equal(out, ref):
                raise AssertionError(f"{kname}: other bits than the interleave")
            log(f"[micro] {kname} B={TRAIN_B}: equal bits to its plain version"
                + (", a probe, not the interleave" if kname == "tile_repeat_probe"
                   else " and to the interleave"))
            if kname == "interleave_onehot":
                bnd, fma = k11d_bound(TRAIN_B, out)
                log(f"[micro] interleave_onehot B={TRAIN_B}: bound {bnd[0]:.4f} ms "
                    f"({len(ONEHOT_PASSES)} bf16 passes on the tensor cores, "
                    f"{peak['bf16_tflops']:.0f} TFLOP/s), f32 FMA bound {fma[0]:.4f} ms")
            else:
                bnd = bound(ph[:, :, :58, :76].numel() * 4 + nbytes(out), 0)
            record(kname, TRAIN_B, 0.0, 0.0, 0.0, time_ms(fn), time_ms(plain), time_ms(lib),
                   bnd, main_b=TRAIN_B)
        err, rel = rel_err(interleave_onehot(ph, er), interleave_onehot_plain(ph, er))
        if not rel <= 1e-5:
            raise AssertionError(f"interleave_onehot, random E: rel {rel:.3e} > 1e-05")
        rows["interleave_onehot"]["max_abs_err"] = err
        log(f"[micro] interleave_onehot B={TRAIN_B}, random E: max_abs_err {err:.3e} "
            f"rel {rel:.3e} (tol 1e-05), {len(ONEHOT_PASSES)} bf16 passes")
        # K11a, K11b and K11d at b=1, and on planes of odd width (the
        # scalar forms of K11b and K11d)
        for b, hp, wp in ((1, *PADDED), (TRAIN_B, 59, 77)):
            php = randn(b, PHASES, hp, wp)
            refp = interleave_window(php)
            shape = "" if (hp, wp) == PADDED else f" {hp}x{wp} planes"
            for kname, fn, plain in (
                    ("interleave_asm", lambda: interleave_asm(php),
                     lambda: interleave_asm_plain(php)),
                    ("interleave_strided", lambda: interleave_strided(php),
                     lambda: interleave_strided_plain(php)),
                    ("interleave_onehot", lambda: interleave_onehot(php, e1),
                     lambda: interleave_onehot_plain(php, e1))):
                out, want = fn(), plain()
                torch.cuda.synchronize()
                if not (torch.equal(out, want) and torch.equal(out, refp)):
                    raise AssertionError(f"{kname} B={b}{shape}: other bits than its "
                                         "plain version or the interleave")
                log(f"[micro] {kname} B={b}{shape}: equal bits to its plain version and "
                    "to the interleave")
                bnd = (k11d_bound(b, out)[0] if kname == "interleave_onehot"
                       else bound(b * PHASES * 58 * 76 * 4 + nbytes(out), 0))
                record(kname, b, 0.0, 0.0, 0.0, time_ms(fn), time_ms(plain),
                       time_ms(lambda: interleave_window(php)), bnd, main_b=TRAIN_B,
                       shape=shape)
            err, rel = rel_err(interleave_onehot(php, er), interleave_onehot_plain(php, er))
            if not rel <= 1e-5:
                raise AssertionError(f"interleave_onehot B={b}{shape}, random E: rel "
                                     f"{rel:.3e} > 1e-05")
            log(f"[micro] interleave_onehot B={b}{shape}, random E: max_abs_err {err:.3e} "
                f"rel {rel:.3e} (tol 1e-05), {len(ONEHOT_PASSES)} bf16 passes")

    def micro_path():
        """The two microbenchmarks' main()s with the counters at 0.
        Returns the counts."""
        wrappers = {"interleave_asm": interleave_asm, "interleave_strided": interleave_strided,
                    "tile_repeat_probe": tile_repeat_probe,
                    "interleave_onehot": interleave_onehot}
        for fn in wrappers.values():
            fn.launches = 0
        ri = microbench_interleave.main(dev)
        ra = microbench_asm.main(dev)
        if not ri["asm_equal"]:
            raise AssertionError("microbench_interleave: K11a is not the interleave")
        if not ri["deconv0_rel"] <= 1e-4:
            raise AssertionError(f"deconv0 channels-last vs NCHW: rel {ri['deconv0_rel']:.3e}")
        for k, r in ra.items():
            if not r["equal"]:
                raise AssertionError(f"microbench_asm {k}: not equal")
        lines = ri["lines"]
        log(f"[micro] deconv0 b={TRAIN_B} 128->256 29x38->58x76: NCHW "
            f"{lines['deconv0 128->256 NCHW out']['us']:.1f} us, channels-last "
            f"{lines['deconv0 128->256 channels-last out']['us']:.1f} us, rel "
            f"{ri['deconv0_rel']:.2e}")
        counts = {k: fn.launches for k, fn in wrappers.items()}
        log(f"[micro] launches on the microbenchmark path: {counts}")
        for k, n in counts.items():
            if n == 0:
                raise AssertionError(f"{k} was not launched on the microbenchmark path")
        return counts

    micro_kernels()
    micro_launches = micro_path()
    log(f"[micro] phase 12: {time.perf_counter() - t_micro:.1f} s")

    # ---- 13. the CLI path ----
    t_cli = time.perf_counter()

    def run_cli(cfg, tag, extra_wrappers=None):
        """``main.main(cfg)`` with the counters at 0 just before; returns
        (test metric means, launches, wall seconds, its standard output)."""
        all_wrappers = {**fwd_wrappers, **bwd_wrappers, **(extra_wrappers or {})}
        for fn in all_wrappers.values():
            fn.launches = 0
        out = io.StringIO()

        class Tee:
            def write(self, text):
                out.write(text)
                return sys.__stdout__.write(text)

            def flush(self):
                sys.__stdout__.flush()

        t0 = time.perf_counter()
        with contextlib.redirect_stdout(Tee()):
            summary = cli_main.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in all_wrappers.items()}
        for k in ("RMSE", "MAE"):
            if not np.isfinite(summary[k]):
                raise AssertionError(f"[cli] {tag}: test {k} = {summary[k]}")
        return summary, launches, wall, out.getvalue()

    def cli_expected(train_steps, eval_forwards):
        """Launches of ``train_steps`` default train steps and
        ``eval_forwards`` eval forwards (12/11/11 each way)."""
        fwd = expected_launches(Config(), fwd_wrappers)
        bwd = expected_launches(Config(), bwd_wrappers)
        return {**{k: n * (train_steps + eval_forwards) for k, n in fwd.items()},
                **{k: n * train_steps for k, n in bwd.items()}}

    def check_cli_launches(tag, got, want):
        if got != want:
            raise AssertionError(f"[cli] {tag}: launches {got}, expected {want}")
        log(f"[cli] {tag}: launches {got} as expected")

    def metric_row(path):
        with open(path) as f:
            row = f.read().splitlines()[-1]
        return np.asarray([float(c.split(":")[1]) for c in row.split(" | ")[1:]])

    t0 = time.perf_counter()
    built = cli_native.available()
    log(f"[cli] native data library: " + (
        f"built, {cli_native.load().path} ({time.perf_counter() - t0:.1f} s)" if built
        else f"not built: {cli_native.unavailable_reason()}; KITTI would decode with PIL"))
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cli_dir = tempfile.mkdtemp(prefix="cli-", dir=build.BUILD_DIR)
    try:
        # 1. train one step, validate, checkpoint, test: the defaults
        # (batch 12 of 228x304, the fork default) on the synthetic scenes
        cfg1 = parse_args(["--data_name", "Synthetic", "--test_pipeline", "--epochs", "1",
                           "--experiments_dir", cli_dir, "--save", "cli"])
        if (cfg1.batch_size, cfg1.patch_height, cfg1.patch_width) != (TRAIN_B, REQ_H, REQ_W):
            raise AssertionError("the CLI's defaults no longer train 12 x 228x304")
        _, got, wall1, _ = run_cli(cfg1, "train")
        check_cli_launches("train 1 step, val and test at b=1", got, cli_expected(1, 2))
        run = cfg1.save_dir
        for artifact in ("args.json", "loss_train.txt", "metric_train.txt",
                         "loss_val.txt", "metric_val.txt", "metric_test.txt",
                         os.path.join("ckpt", "model_00001.pt"),
                         os.path.join("code", "nlspn_eccv20_tpu_torch", "main.py")):
            if not os.path.exists(os.path.join(run, artifact)):
                raise AssertionError(f"[cli] no {artifact} in {run}")
        ckpt_mb = os.path.getsize(os.path.join(run, "ckpt", "model_00001.pt")) / 2**20
        log(f"[cli] run 1 (train 1 step of {TRAIN_B} x {REQ_H}x{REQ_W}, val and test "
            f"1 image each, checkpoint): wall {wall1:.2f} s, {(TRAIN_B + 2) / wall1:.2f} "
            f"images/s; checkpoint {ckpt_mb:.1f} MB (weights and Adam state); every "
            f"artifact written; {card}")

        # 2. resume: the resume rule reloads args.json (epochs 1 with it),
        # so the smoke asks for a second epoch on the reloaded config
        cfg2 = parse_args(["--resume", "--pretrain", run]).replace(epochs=2)
        saved_step = CheckpointManager(cfg2).restore(1)["step"]
        _, got, wall2, out2 = run_cli(cfg2, "resume")
        check_cli_launches("resumed epoch 2: 1 step, val and test", got, cli_expected(1, 2))
        if "resumed from epoch 1" not in out2:
            raise AssertionError("[cli] the run did not resume from epoch 1")
        lr_line = next(ln for ln in out2.splitlines() if "Epoch    2/2 | lr" in ln)
        lr = float(lr_line.split("lr")[1].split("|")[0])
        # --test_pipeline took 1 of the epoch's steps_per_epoch steps, so the
        # optimizer resumes at step 1; both steps give the warm-up's end
        spe = len(Synthetic(cfg2, "train")) // TRAIN_B
        schedule = make_lr_schedule(cfg2, spe)
        if any(abs(lr - schedule(step)) > 1e-6 * lr for step in (saved_step, spe)):
            raise AssertionError(f"[cli] resumed lr {lr}: the schedule gives "
                                 f"{schedule(saved_step)} at the saved step "
                                 f"{saved_step}, {schedule(spe)} at step {spe}")
        log(f"[cli] run 2 (resume from epoch 1, epoch 2): first lr {lr:.6f} = the "
            f"schedule at the saved step {saved_step} and at step {spe} "
            f"(steps_per_epoch); wall {wall2:.2f} s, {(TRAIN_B + 2) / wall2:.2f} "
            f"images/s; {card}")

        # 3. test only, from the experiment directory: the same weights and data
        cfg3 = parse_args(["--test_only", "--pretrain", run, "--data_name", "Synthetic",
                           "--test_pipeline", "--experiments_dir", cli_dir,
                           "--save", "cli_test"])
        _, got, wall3, _ = run_cli(cfg3, "test_only")
        check_cli_launches("test_only: 1 forward at b=1", got, cli_expected(0, 1))
        # the rows as written, 5 decimals: 1e-5 absolute covers the rounding
        row2 = metric_row(os.path.join(run, "metric_test.txt"))
        row3 = metric_row(os.path.join(cfg3.save_dir, "metric_test.txt"))
        rel = np.max(np.abs(row3 - row2) / np.maximum(np.abs(row2), 1e-6))
        if not np.allclose(row3, row2, rtol=2e-4, atol=1e-5):
            raise AssertionError(f"[cli] test_only row {row3} vs the resumed run's "
                                 f"{row2}: rel {rel:.3e}")
        log(f"[cli] run 3 (test_only --pretrain the run): metric row within {rel:.3e} "
            f"relative of run 2's own test row; wall {wall3:.2f} s, "
            f"{1 / wall3:.2f} images/s; {card}")

        # 4. serve the checkpoint file
        pt = os.path.join(run, "ckpt", "model_00002.pt")
        predictor = Predictor(Config(), checkpoint=pt, device=dev)
        rng = np.random.default_rng(8)
        rgb = rng.integers(0, 256, (REQ_H, REQ_W, 3), dtype=np.uint8)
        dep = np.zeros((REQ_H, REQ_W), np.float32)
        dep.flat[rng.choice(REQ_H * REQ_W, 500, replace=False)] = rng.uniform(0.5, 10.0, 500)
        for fn in fwd_wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        answer = predictor.predict(rgb, dep)
        serve_ms = (time.perf_counter() - t0) * 1e3
        got = {k: fn.launches for k, fn in fwd_wrappers.items()}
        check_cli_launches("Predictor(checkpoint=...): 1 request",
                           got, expected_launches(Config(), fwd_wrappers))
        sample, _ = predictor.make_sample([rgb], [dep])
        with torch.inference_mode():
            plain = with_plain_versions(
                lambda: predictor.model(sample, need_inter=False))["pred"]
        plain = plain[0, 0, :REQ_H, :REQ_W].cpu().numpy()
        rel = np.max(np.abs(answer - plain)) / max(np.max(np.abs(plain)), 1.0)
        if answer.shape != (REQ_H, REQ_W) or not rel <= 2e-4:
            raise AssertionError(f"[cli] served answer {answer.shape}: rel {rel:.3e}")
        log(f"[cli] Predictor(checkpoint=model_00002.pt) answered one {REQ_H}x{REQ_W} "
            f"request in {serve_ms:.1f} ms (its first, cuDNN picking algorithms), within "
            f"{rel:.3e} of the plain versions' forward; {card}")
    except BaseException:
        shutil.rmtree(cli_dir, ignore_errors=True)
        raise
    log(f"[cli] phase 13: {time.perf_counter() - t_cli:.1f} s")

    # ---- 14. bf16 serving ----
    t_bf16 = time.perf_counter()
    k2_bf16_splits = set()

    def check_bf16(kname, b, shape, kernel, plain, library, args, out_of, flops,
                   share_bar=None):
        """A bf16 kernel against its plain version on ``args``: equal bits in
        two runs, within one bf16 ulp of the largest plain output, the share
        of elements not bit-equal (at most ``share_bar`` where given); timed
        beside its plain version, the library call and its bound (bytes as
        the tensors lie, bf16 operations)."""
        out, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        tag = f"{kname} B={b}{shape}"
        if not same_bits(lambda: (kernel(*args),)):
            raise AssertionError(f"{tag}: two runs gave other bits")
        err, rel = rel_err(out_of(out), out_of(ref))
        share = (out_of(out) != out_of(ref)).float().mean().item()
        log(f"[bf16] {tag}: equal bits in two runs; {share:.3e} of the elements not "
            f"bit-equal to the plain version"
            + ("" if share_bar is None else f" (bar {share_bar:.0e})"))
        if share_bar is not None and not share <= share_bar:
            raise AssertionError(f"{tag}: {share:.3e} of the elements not bit-equal")
        record(kname, b, err, rel, ulp, time_ms(lambda: kernel(*args)),
               time_ms(lambda: plain(*args)), time_ms(library),
               bound(nbytes(*args, out), flops, "bf16_tflops"), shape=shape)

    def check_k2_bf16(b, hg, wg, k=8, c=256):
        """K2-bf16's output, then its training form's (out, y1), each at
        most 1e-2 not bit-equal; its plan as the source reports it."""
        (x, w1, b1, w2, b2), _ = decode_aff_tail_case(gen, dev, b, hg, wg, k, c)
        args = (x.to(bf16), w1, b1, w2, b2)
        plan = tail_plan_bf16(b, hg, wg, c, k, sms)
        if tail_plan_bf16_card(b, hg, wg, c, k, sms) != plan:
            raise AssertionError(f"decode_aff_tail_bf16 {b} {hg}x{wg} K={k} C={c}: the "
                                 f"source's plan {tail_plan_bf16_card(b, hg, wg, c, k, sms)}"
                                 f", its mirror's {plan}")
        k2_bf16_splits.add(plan["split"])
        xn, w1b, b1b, w2b, b2b = (x.permute(0, 3, 1, 2).to(bf16).contiguous(),
                                  w1.to(bf16), b1.to(bf16), w2.to(bf16), b2.to(bf16))

        def library():   # cuDNN's two bf16 transposed convs, NCHW
            y1 = F.relu(F.conv_transpose2d(xn, w1b, b1b, 2, 1, 1))
            return F.conv_transpose2d(y1, w2b, b2b, 2, 1, 1)

        shape = "" if (hg, wg, k, c) == (H // 4, W // 4, 8, 256) else f" {hg}x{wg} K={k} C={c}"
        flops = 2 * b * (taps_t2(hg) * taps_t2(wg) * c * 16
                         + taps_t2(2 * hg) * taps_t2(2 * wg) * 16 * k)
        check_bf16("decode_aff_tail_bf16", b, shape, decode_aff_tail_bf16,
                   decode_aff_tail_plain_bf16, library, args, lambda t: t, flops,
                   share_bar=1e-2)
        for i, part in enumerate(("out", "y1")):   # the training form
            got = decode_aff_tail_fwd_y1(*args)[i]
            want = decode_aff_tail_plain_bf16_y1(*args)[i]
            share = (got != want).float().mean().item()
            err = rel_err(got, want)[1]
            log(f"[bf16] decode_aff_tail_bf16 B={b}{shape} with y1: its {part} within "
                f"{err:.3e} of max |plain| (bar 2^-7), {share:.3e} not bit-equal (bar 1e-2)")
            if not (share <= 1e-2 and err <= ulp):
                raise AssertionError(f"decode_aff_tail_bf16 B={b}{shape}: {part} of the "
                                     f"training form {err:.3e}, {share:.3e} not bit-equal")

    def check_k3_bf16(b, h, w, c=256):
        """K3-bf16 at most 1e-2 not bit-equal; its plan as the source
        reports it."""
        (plane, w0, b0, w1, b1), _ = dep_encode_front_case(gen, dev, b, h, w, c)
        args = (plane.to(bf16), w0, b0, w1, b1)
        shape = "" if (h, w, c) == (H, W, 256) else f" {h}x{w} C1={c}"
        plan = front_plan_bf16(b, h, w, c, sms)
        if front_plan_bf16_card(b, h, w, c, sms) != plan:
            raise AssertionError(f"dep_encode_front_bf16 B={b}{shape}: the source's plan "
                                 f"{front_plan_bf16_card(b, h, w, c, sms)}, its mirror's {plan}")
        p4, w0b, b0b, w1b, b1b = (args[0][:, None], w0.to(bf16), b0.to(bf16),
                                  w1.to(bf16), b1.to(bf16))

        def library():   # cuDNN's two bf16 convs with their ReLUs, NCHW out
            return F.relu(F.conv2d(F.relu(F.conv2d(p4, w0b, b0b, 2, 1)), w1b, b1b, 2, 1))

        flops = 2 * b * (taps_s2(h) * taps_s2(w) * 16
                         + taps_s2((h + 1) // 2) * taps_s2((w + 1) // 2) * 16 * c)
        check_bf16("dep_encode_front_bf16", b, shape, dep_encode_front_bf16,
                   dep_encode_front_plain_bf16, library, args, lambda t: t.float(), flops,
                   share_bar=1e-2)
        log(f"[bf16] dep_encode_front_bf16 B={b}{shape}: its plan {plan} equal to "
            f"front_plan_bf16's")

    bf16_wrappers = {"decode_aff_tail_bf16": decode_aff_tail_bf16,
                     "dep_encode_front_bf16": dep_encode_front_bf16}
    bf16_plain_of = {**plain_of, "decode_aff_tail": decode_aff_tail_plain_bf16,
                     "dep_encode_front": dep_encode_front_plain_bf16}

    def expected_bf16(cfg):
        """Launches a bf16 forward of ``cfg`` makes: the f32 forward's, with
        K2's and K3's moved to their bf16 forms."""
        want = expected_launches(cfg, fwd_wrappers)
        return {**want, "decode_aff_tail": 0, "dep_encode_front": 0,
                "decode_aff_tail_bf16": want["decode_aff_tail"],
                "dep_encode_front_bf16": want["dep_encode_front"]}

    def busy_ms(fn, iters=3):
        """Device busy time of one call: its kernels' device times summed
        by torch.profiler over ``iters`` calls, a call's share."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(a, "self_device_time_total", 0.0) or a.self_cuda_time_total
                 for a in prof.key_averages()
                 if a.device_type == torch.autograd.DeviceType.CUDA)
        return us / 1e3 / iters

    def serve_bf16(kw, tag):
        """The configuration ``kw`` served in bf16 beside f32 at the same
        random weights; returns the bf16 run's launches."""
        cfg = Config(precision="bf16", **kw)
        weights = randomize_(get_model(cfg, dev), torch.Generator().manual_seed(1))
        pred = {p: Predictor(cfg.replace(precision=p), state_dict=weights.state_dict(),
                             device=dev) for p in ("f32", "bf16")}
        del weights
        rng = np.random.default_rng(2)

        def request():
            rgb = rng.integers(0, 256, (REQ_H, REQ_W, 3), dtype=np.uint8)
            dep = np.zeros((REQ_H, REQ_W), np.float32)
            idx = rng.choice(REQ_H * REQ_W, cfg.num_sample, replace=False)
            dep.flat[idx] = rng.uniform(0.5, 10.0, cfg.num_sample)
            return rgb, dep

        wrappers = {**fwd_wrappers, **bf16_wrappers}
        per_forward = expected_bf16(cfg)
        batches = [[request()] for _ in range(4)] + [[request() for _ in range(4)]]
        for fn in wrappers.values():
            fn.launches = 0
        before = {k: 0 for k in wrappers}
        for reqs in batches:
            outs = pred["bf16"].predict_batch([r for r, _ in reqs], [d for _, d in reqs])
            for (_, dep), out in zip(reqs, outs):
                if (out.shape != (REQ_H, REQ_W) or out.dtype != np.float32
                        or not np.isfinite(out).all()):
                    raise AssertionError(f"[bf16{tag}] bad output {out.shape} {out.dtype}")
                if not np.array_equal(out[dep > 0], dep[dep > 0]):
                    raise AssertionError(f"[bf16{tag}] observed depth not kept")
            for k, fn in wrappers.items():
                if fn.launches - before[k] != per_forward[k]:
                    raise AssertionError(f"[bf16{tag}] {k}: {fn.launches - before[k]} "
                                         f"launches in one forward, expected {per_forward[k]}")
                before[k] = fn.launches
        launches = {k: fn.launches for k, fn in wrappers.items()}
        log(f"[bf16{tag}] {len(batches)} forwards (4 x b=1, 1 x b=4) of {REQ_H}x{REQ_W}: "
            f"outputs finite f32, observed depth kept exactly; launches {launches} = "
            f"{per_forward} per forward")

        sample, _ = pred["bf16"].make_sample([r for r, _ in batches[-1]],
                                             [d for _, d in batches[-1]])
        with torch.inference_mode():
            out_k = pred["bf16"].model(sample, need_inter=False)["pred"]
            out_p = with_plain_versions(lambda: pred["bf16"].model(
                sample, need_inter=False)["pred"], bf16_plain_of)
            out_f = pred["f32"].model(sample, need_inter=False)["pred"]
        scale = out_p.abs().max().item()
        err = (out_k - out_p).abs().max().item()
        gap = (out_k - out_f).abs().max().item()
        log(f"[bf16{tag}] b=4 pred, kernels vs plain versions (both bf16): max |d| "
            f"{err:.3e} = {err / scale:.3e} of max |pred| {scale:.3f} (bar 1e-2); "
            f"bf16 vs f32 at the same weights (not gated): max |d| {gap:.3e}, "
            f"{gap / scale:.3e} of max |pred|")
        if not err <= 1e-2 * scale:
            raise AssertionError(f"[bf16{tag}] kernels vs plain: {err:.3e} > 1e-2 x {scale:.3f}")

        for b in (1, 4):
            s = {k: v[:b] for k, v in sample.items()}
            line = []
            for p in ("f32", "bf16", "bf16", "f32"):
                lat = pred[p].benchmark(REQ_H, REQ_W, batch=b, calls=10, seed=3)["median_s"]
                with torch.inference_mode():
                    busy = busy_ms(lambda: pred[p].model(s, need_inter=False))
                line.append(f"{p} {lat * 1e3:.3f} / {busy:.3f}")
            log(f"[bf16{tag}] b={b} predict_batch latency median / device busy a forward, "
                f"ms (in turns): {'; '.join(line)}; {card}")
        return launches

    try:
        # the kernels at the serving shapes (timed rows of the kernel line:
        # B=1), B=4 and KITTI's B=1; K2's other grids give every cluster size
        for b in (1, 4):
            check_k2_bf16(b, H // 4, W // 4)
            check_k3_bf16(b, H, W)
        check_k2_bf16(1, KITTI_H // 4, KITTI_W // 4)
        check_k3_bf16(1, KITTI_H, KITTI_W)
        check_k2_bf16(1, H // 4, W // 4, k=24)
        check_k2_bf16(2, H // 4, W // 4)
        check_k2_bf16(TRAIN_B, 58, 76)
        check_k2_bf16(1, 57, 75)
        check_k2_bf16(1, H // 4, W // 4, c=40)
        check_k2_bf16(1, 58, 76, c=30)
        check_k2_bf16(1, 29, 38)
        check_k2_bf16(1, 40, 64)
        if k2_bf16_splits != set(SPLITS):
            raise AssertionError(f"decode_aff_tail_bf16: cluster sizes "
                                 f"{sorted(k2_bf16_splits)} checked, its plan picks {SPLITS}")
        check_k3_bf16(TRAIN_B, REQ_H, REQ_W)
        check_k3_bf16(1, REQ_H, REQ_W, c=96)
        check_k3_bf16(1, 230, 306)
        log(f"[bf16] kernels: {time.perf_counter() - t_bf16:.1f} s")

        bf16_launches = serve_bf16({}, "")
        serve_bf16({"offset": True}, " offset")
        serve_bf16(LOOP, " loop")
        torch.cuda.empty_cache()

        # phase 13's checkpoint tested in bf16 beside its f32 test row
        cfg_b = parse_args(["--test_only", "--pretrain", run, "--data_name", "Synthetic",
                            "--test_pipeline", "--experiments_dir", cli_dir, "--save",
                            "cli_test_bf16", "--precision", "bf16"])
        _, got, wall_b, _ = run_cli(cfg_b, "test_only bf16", bf16_wrappers)
        check_cli_launches("test_only --precision bf16: 1 forward at b=1", got,
                           {**{k: 0 for k in bwd_wrappers}, **expected_bf16(cfg_b)})
        row_b = metric_row(os.path.join(cfg_b.save_dir, "metric_test.txt"))
        log(f"[cli] --precision bf16 --test_only: metric row {np.round(row_b, 5).tolist()} "
            f"beside the f32 test row {np.round(row3, 5).tolist()} (not gated); wall "
            f"{wall_b:.2f} s; {card}")
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    log(f"[bf16] phase 14: {time.perf_counter() - t_bf16:.1f} s")

    # ---- 15. bf16 training ----
    t_bt = time.perf_counter()

    def check_bwd_bf16(kname, b, shape, kernel, plain, library, args, flops):
        """K4-bf16 or K5-bf16 against its plain version on ``args``: equal
        bits in two runs; each output at its own bar: the bf16 input
        gradient within one bf16 ulp of its largest plain value (2^-7 of
        it) with at most 1e-3 of its elements not bit-equal, each f32
        weight and bias gradient within 5e-4 of its largest plain value (a
        kernel that leaves out one of the TPU kernel's rounding points puts
        about 40% of the input gradient's elements off and moves a weight
        or bias gradient by 1e-3 or more: ``tests/test_torch_bf16_train.py``);
        timed beside its plain version, cuDNN's bf16 backward of the same
        two convs and its bound (bytes as the tensors lie, bf16
        operations)."""
        outs, refs = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        tag = f"{kname} B={b}{shape}"
        if not same_bits(lambda: kernel(*args)):
            raise AssertionError(f"{tag}: two runs gave other bits")
        errs = [rel_err(o.float(), r.float()) for o, r in zip(outs, refs)]
        share = (outs[0] != refs[0]).float().mean().item()
        log(f"[bf16-train] {tag}: equal bits in two runs; relative error of each "
            f"output {[f'{r:.2e}' for _, r in errs]} (bars 2^-7, then 5e-4 each); "
            f"{share:.3e} of the input gradient's elements not bit-equal to the plain "
            f"version (bar 1e-3)")
        if not share <= 1e-3:
            raise AssertionError(f"{tag}: {share:.3e} of the input gradient not bit-equal")
        for i, (_, r) in enumerate(errs[1:], 1):
            if not r <= 5e-4:
                raise AssertionError(f"{tag}: output {i} (f32) relative error {r:.3e} > 5e-4")
        record(kname, b, max(e for e, _ in errs), errs[0][1], ulp,
               time_ms(lambda: kernel(*args)), time_ms(lambda: plain(*args)),
               time_ms(library), bound(nbytes(*args, *outs), flops, "bf16_tflops"),
               main_b=TRAIN_B, shape=shape)

    def check_k4_bf16(b, hg, wg, k=8, c=256):
        args, library = decode_aff_tail_bwd_case(gen, dev, b, hg, wg, k, c, dtype=bf16)
        flops = 2 * 2 * b * (taps_t2(hg) * taps_t2(wg) * c * 16
                             + taps_t2(2 * hg) * taps_t2(2 * wg) * 16 * k)
        shape = "" if (hg, wg, k, c) == (58, 76, 8, 256) else f" {hg}x{wg} K={k} C={c}"
        check_bwd_bf16("decode_aff_tail_bwd_bf16", b, shape, decode_aff_tail_bwd_bf16,
                       decode_aff_tail_bwd_plain_bf16, library, args, flops)

    def check_k5_bf16(b, h, w, c=256):
        plan = front_bwd_plan_bf16(b, h, w, c)
        if front_bwd_plan_bf16_card(b, h, w, c) != plan:
            raise AssertionError(f"dep_encode_front_bwd_bf16 {b} {h}x{w} C1={c}: the "
                                 f"source's plan {front_bwd_plan_bf16_card(b, h, w, c)}, "
                                 f"its mirror's {plan}")
        args, library = dep_encode_front_bwd_case(gen, dev, b, h, w, c, dtype=bf16)
        flops = 2 * b * (3 * taps_s2(h) * taps_s2(w) * 16
                         + 2 * taps_s2((h + 1) // 2) * taps_s2((w + 1) // 2) * 16 * c)
        shape = "" if (h, w, c) == (REQ_H, REQ_W, 256) else f" {h}x{w} C1={c}"
        check_bwd_bf16("dep_encode_front_bwd_bf16", b, shape, dep_encode_front_bwd_bf16,
                       dep_encode_front_bwd_plain_bf16, library, args, flops)

    class PlainTail(torch.autograd.Function):
        """K2-bf16's and K4-bf16's plain versions as one autograd Function."""

        @staticmethod
        def forward(ctx, x, w1, b1, w2, b2):
            out, y1 = decode_aff_tail_plain_bf16_y1(x, w1, b1, w2, b2)
            ctx.save_for_backward(x, w1, w2, y1)
            return out

        @staticmethod
        def backward(ctx, g):
            return decode_aff_tail_bwd_plain_bf16(g, *ctx.saved_tensors)

    class PlainFront(torch.autograd.Function):
        """K3-bf16's and K5-bf16's plain versions as one autograd Function."""

        @staticmethod
        def forward(ctx, x, w0, b0, w1, b1):
            out = dep_encode_front_plain_bf16(x, w0, b0, w1, b1)
            ctx.save_for_backward(x, w0, b0, w1, out)
            return out

        @staticmethod
        def backward(ctx, g):
            return dep_encode_front_bwd_plain_bf16(g, *ctx.saved_tensors)

    bf16_train_plain = {**plain_of, "decode_aff_tail": PlainTail.apply,
                        "dep_encode_front": PlainFront.apply}
    bt_wrappers = {**fwd_wrappers, **bwd_wrappers, **bf16_wrappers,
                   "decode_aff_tail_bwd_bf16": decode_aff_tail_bwd_bf16,
                   "dep_encode_front_bwd_bf16": dep_encode_front_bwd_bf16}

    def expected_bf16_train(cfg, steps=1, forwards=0):
        """Launches of ``steps`` bf16 train steps and ``forwards`` bf16 eval
        forwards of ``cfg``: the f32 ones with K2-K5 moved to their bf16
        forms."""
        fwd = expected_launches(cfg, fwd_wrappers)
        bwd = expected_launches(cfg, bwd_wrappers)
        want = {**{k: n * (steps + forwards) for k, n in fwd.items()},
                **{k: n * steps for k, n in bwd.items()}}
        for k in ("decode_aff_tail", "dep_encode_front", "decode_aff_tail_bwd",
                  "dep_encode_front_bwd"):
            want[k + "_bf16"], want[k] = want[k], 0
        return want

    def train_bf16(kw, tag):
        """5 bf16 Engine steps of ``kw`` at batch 12 of 228x304 (random
        weights, seed 4 as phases 7 and 8): launches, finite losses, f32
        gradients; one step through the kernels against the same step
        through their plain versions; then the bf16 step's time and peak
        memory beside the f32 step's at the same weights. Returns the
        launches."""
        cfg = Config(precision="bf16", **kw)
        eng = Engine(cfg, steps_per_epoch=100, device=dev)
        randomize_(eng.model, torch.Generator().manual_seed(4))
        model = eng.init_state()
        data = Synthetic(cfg, "train")
        drng = np.random.default_rng(5)
        tb = [eng.put_batch(data.batch([(i * TRAIN_B + j) % len(data)
                                        for j in range(TRAIN_B)], drng))
              for i in range(TRAIN_STEPS)]
        per_step = expected_bf16_train(cfg)
        for fn in bt_wrappers.values():
            fn.launches = 0
        losses = []
        for i in range(TRAIN_STEPS):
            before = {k: fn.launches for k, fn in bt_wrappers.items()}
            aux = eng.train_step(tb[i])
            got = {k: fn.launches - before[k] for k, fn in bt_wrappers.items()}
            if got != per_step:
                raise AssertionError(f"[bf16-train{tag}] step {i}: launches {got}, "
                                     f"expected {per_step}")
            losses.append(aux["loss"].item())
            if aux["loss"].dtype != torch.float32 or not np.isfinite(losses[-1]):
                raise AssertionError(f"[bf16-train{tag}] step {i}: loss {aux['loss']}")
            for pname, p in model.named_parameters():
                if p.grad is None or p.grad.dtype != torch.float32 \
                        or not torch.isfinite(p.grad).all():
                    raise AssertionError(f"[bf16-train{tag}] step {i}: {pname} has no "
                                         f"finite f32 gradient")
        launches = {k: fn.launches for k, fn in bt_wrappers.items()}
        log(f"[bf16-train{tag}] {TRAIN_STEPS} bf16 steps of {TRAIN_B} x {REQ_H}x{REQ_W}: "
            f"losses {[round(v, 4) for v in losses]}, finite f32; every parameter a "
            f"finite f32 gradient; launches per step "
            f"{ {k: n for k, n in per_step.items() if n} } (the others 0)")

        # one step through the kernels against the same step through their
        # plain versions, from the same parameters, cuDNN deterministic; the
        # bar: 1e-2 on the loss, and on each gradient 5e-2 relative L2 or,
        # where bf16 moves it farther, twice the plain bf16 step's distance
        # from the f32 step at the same weights, never past 0.5 (the CPU
        # tests' bar)
        batch = tb[0]
        f32_model = get_model(cfg.replace(precision="f32"), dev)
        f32_model.load_state_dict(model.state_dict())
        f32_model.train()

        def loss_and_grads(m):
            m.zero_grad(set_to_none=True)
            out = m(batch, need_inter=False)
            loss = eng.loss_fn(batch, out)[0] / TRAIN_B
            loss.backward()
            return loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()}

        def dist(a, b):
            return (a - b).norm().item() / max(b.norm().item(), 1e-30)

        stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            loss_k, gk = loss_and_grads(model)
            _, gk2 = loss_and_grads(model)
            loss_p, gp = with_plain_versions(lambda: loss_and_grads(model), bf16_train_plain)
            loss_f, gf = loss_and_grads(f32_model)
        model.load_state_dict({**model.state_dict(), **stats})
        rows = [(dist(gk[n], gp[n]), dist(gp[n], gf[n]), n) for n in gp
                if gp[n].abs().max() > 0]
        ratios = [gk[n].norm().item() / gp[n].norm().item() for _, _, n in rows]

        def bar(noise):
            return min(max(5e-2, 2 * noise), 0.5)

        worst = max(rows, key=lambda r: r[0] / bar(r[1]))
        floor = max(dist(gk2[n], gk[n]) for n in gk)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        log(f"[bf16-train{tag}] one step, kernels vs plain versions (both bf16): loss "
            f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel:.3e}, bar 1e-2); gradients within "
            f"5e-2 rel L2: {sum(r[0] <= 5e-2 for r in rows)} of {len(rows)}, largest "
            f"{max(r[0] for r in rows):.3e}, nearest its bar {worst[0]:.3e} at {worst[2]} "
            f"(plain bf16 vs f32 {worst[1]:.3e}, bar {bar(worst[1]):.3e}); norms "
            f"{min(ratios):.4f} to {max(ratios):.4f} of the plain step's (bar 3/4 to 4/3); "
            f"kernels against themselves {floor:.3e}; bf16 vs f32 loss {loss_f:.6f} (rel "
            f"{abs(loss_k - loss_f) / abs(loss_f):.3e}); cuDNN deterministic")
        if not rel <= 1e-2:
            raise AssertionError(f"[bf16-train{tag}] loss: rel {rel:.3e} > 1e-2")
        for (d, noise, n), ratio in zip(rows, ratios):
            if not d <= bar(noise):
                raise AssertionError(f"[bf16-train{tag}] gradient {n}: rel L2 {d:.3e}, "
                                     f"bf16 vs f32 {noise:.3e}")
            if not 3 / 4 <= ratio <= 4 / 3:
                raise AssertionError(f"[bf16-train{tag}] gradient {n}: norm x{ratio:.4f} "
                                     f"of the plain step's")
        del gk, gk2, gp, gf, f32_model, model

        # the step's time and peak memory, bf16 beside f32 at the same
        # initial weights, each engine alone on the card
        times = {}
        for p in ("bf16", "f32"):
            if p == "bf16":
                e, eng = eng, None
            else:
                e = Engine(cfg.replace(precision="f32"), steps_per_epoch=100, device=dev)
                randomize_(e.model, torch.Generator().manual_seed(4))
                e.init_state()
                e.train_step(tb[0])        # cuDNN picks its algorithms
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for i in range(TRAIN_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                e.train_step(tb[i])
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            times[p] = (sorted(ms)[len(ms) // 2], min(ms),
                        torch.cuda.max_memory_allocated() / 2**30)
            del e
            torch.cuda.empty_cache()
        log(f"[bf16-train{tag}] b={TRAIN_B} train step (CUDA events, forward + loss + "
            f"backward + Adam), median / min over {TRAIN_STEPS} steps and peak memory: "
            + "; ".join(f"{p} {t[0]:.3f} / {t[1]:.3f} ms, {t[2]:.3f} GiB"
                        for p, t in times.items()) + f"; {card}")
        return launches

    bt_dir = tempfile.mkdtemp(prefix="cli-bf16-", dir=build.BUILD_DIR)
    try:
        # (a) the kernels at the train step's shape (the kernel line's rows),
        # at b=1 and at shapes their tiles make risky: K4 with K = 24 on an
        # uneven grid and with C = 30 (channels not in 16-byte groups), K5
        # with C1 = 96, C1 = 30 and on a 230x306 plane
        for b in (TRAIN_B, 1):
            check_k4_bf16(b, 58, 76)
            check_k5_bf16(b, REQ_H, REQ_W)
        check_k4_bf16(1, 57, 75, k=24)
        check_k4_bf16(1, 58, 76, c=30)
        check_k5_bf16(1, REQ_H, REQ_W, c=96)
        check_k5_bf16(1, REQ_H, REQ_W, c=30)
        check_k5_bf16(2, 230, 306)
        log(f"[bf16-train] kernels: {time.perf_counter() - t_bt:.1f} s")

        # (b), (c) the three configurations trained in bf16
        bt_launches = train_bf16({}, "")
        train_bf16({"offset": True}, " offset")
        loop_bt = train_bf16(LOOP, " loop")
        if loop_bt["decode_aff_tail_bwd_bf16"] or loop_bt["dep_encode_front_bwd_bf16"]:
            raise AssertionError("[bf16-train loop] K4-bf16 or K5-bf16 launched")
        torch.cuda.empty_cache()

        # (d) the CLI in bf16: train one epoch, resume for a second, test
        cfg_t = parse_args(["--data_name", "Synthetic", "--test_pipeline", "--epochs", "1",
                            "--experiments_dir", bt_dir, "--save", "cli_bf16",
                            "--precision", "bf16"])
        extra = {k: bt_wrappers[k] for k in bt_wrappers if k.endswith("_bf16")}
        _, got, wall_t, _ = run_cli(cfg_t, "train bf16", extra)
        check_cli_launches("--precision bf16: train 1 step, val and test at b=1", got,
                           expected_bf16_train(cfg_t, 1, 2))
        run_b = cfg_t.save_dir
        net = torch.load(os.path.join(run_b, "ckpt", "model_00001.pt"),
                         weights_only=True)["net"]
        if any(v.dtype == torch.bfloat16 for v in net.values()):
            raise AssertionError("[cli] a bf16 run's checkpoint holds bf16 weights")
        cfg_r = parse_args(["--resume", "--pretrain", run_b]).replace(epochs=2)
        _, got, wall_r, out_r = run_cli(cfg_r, "resume bf16", extra)
        check_cli_launches("--precision bf16 resumed epoch 2", got,
                           expected_bf16_train(cfg_r, 1, 2))
        if "resumed from epoch 1" not in out_r or cfg_r.precision != "bf16":
            raise AssertionError("[cli] the bf16 run did not resume in bf16 from epoch 1")
        cfg_o = parse_args(["--test_only", "--pretrain", run_b, "--data_name", "Synthetic",
                            "--test_pipeline", "--experiments_dir", bt_dir, "--save",
                            "cli_bf16_test", "--precision", "bf16"])
        _, got, wall_o, _ = run_cli(cfg_o, "test_only bf16", extra)
        check_cli_launches("--precision bf16 --test_only", got,
                           expected_bf16_train(cfg_o, 0, 1))
        f32_answer = Predictor(Config(), checkpoint=os.path.join(
            run_b, "ckpt", "model_00002.pt"), device=dev).predict(
            np.zeros((REQ_H, REQ_W, 3), np.uint8), np.ones((REQ_H, REQ_W), np.float32))
        if not np.isfinite(f32_answer).all():
            raise AssertionError("[cli] the bf16 run's checkpoint served non-finite depth")
        log(f"[cli] --precision bf16: train 1 epoch {wall_t:.2f} s, resume for epoch 2 "
            f"{wall_r:.2f} s, --test_only {wall_o:.2f} s; checkpoints hold f32 weights, "
            f"which an f32 Predictor serves; {card}")
    finally:
        shutil.rmtree(bt_dir, ignore_errors=True)
    log(f"[bf16-train] phase 15: {time.perf_counter() - t_bt:.1f} s")

    # ---- 16. data parallel ----
    t_dp = time.perf_counter()
    dp_dir = tempfile.mkdtemp(prefix="dp-", dir=build.BUILD_DIR)
    try:
        data_parallel(dp_dir, dev, card, step_medians[""], expected_launches(
            Config(), {**fwd_wrappers, **bwd_wrappers}), expected_bf16_train(
            Config(precision="bf16")))
    finally:
        shutil.rmtree(dp_dir, ignore_errors=True)
    log(f"[dp] phase 16: {time.perf_counter() - t_dp:.1f} s")

    # ---- 17. width sharding ----
    t_ws = time.perf_counter()
    # (0) K1-K5, K7, K8 and the bf16 forms of K2-K5 at the shapes the strips
    # give them, against their plain versions at their usual bars: two and
    # three strips of a batch of 240x1216 (the backwards of the default
    # model at two, as its ranks train), each strip extended as
    # models/nlspn.py extends it: K1 and K1b by prop_kernel // 2 columns a
    # side, K3 and K5 by 4 on the left, K2 and K4 by one on the right at 1/4,
    # K7 and K8 in training by the windowed backward's reach prop_kernel // 2
    # + R + 1 a side, K7 in eval by the offsets' own reach (predicted in
    # width_sharding) or on the whole width, none past the image's edges.
    # The ranks note the shapes their wrappers were given; each must be one
    # of these.
    from nlspn_eccv20_tpu_torch.parallel.mesh import strip_bounds
    strip_shapes = set()

    def check_strip_shape(shape, backward=True):
        """``shape``'s kernel (and with ``backward`` its backward) against
        its plain version at B=2; noted in ``strip_shapes``."""
        if shape in strip_shapes:
            return
        strip_shapes.add(shape)
        kind, sh, sw = shape[:3]
        if kind == "prop_step":
            check_k1(WS_B, sh, sw)
            if backward:
                check_k1b(WS_B, sh, sw)
        elif kind == "dep_encode_front":
            check_k3(WS_B, sh, sw)
            check_k3_bf16(WS_B, sh, sw)
            if backward:
                check_k5(WS_B, sh, sw)
                check_k5_bf16(WS_B, sh, sw)
        elif kind == "decode_aff_tail":
            check_k2(WS_B, sh, sw)
            check_k2_bf16(WS_B, sh, sw)
            if backward:
                check_k4(WS_B, sh, sw, 8)
                check_k4_bf16(WS_B, sh, sw)
        elif kind == "deform_prop":
            check_k7(WS_B, sh, sw, radius=shape[3])
        elif kind == "deform_prop_bwd":
            check_k8(WS_B, sh, sw, radius=shape[3])
        else:
            raise AssertionError(f"[ws] no check for {shape}")

    rp = Config().prop_kernel // 2 + RADIUS + 1
    for n in (2, 3):
        sb = strip_bounds(KITTI_W, n)
        for i in range(n):
            inner_l, inner_r, w = int(i > 0), int(i < n - 1), sb[i + 1] - sb[i]
            for shape in (("prop_step", KITTI_H, w + inner_l + inner_r),
                          ("dep_encode_front", KITTI_H, w + 4 * inner_l),
                          ("decode_aff_tail", KITTI_H // 4, w // 4 + inner_r)):
                check_strip_shape(shape, backward=n == 2)
            wide = w + rp * (inner_l + inner_r)
            check_strip_shape(("deform_prop", KITTI_H, wide, RADIUS))
            check_strip_shape(("deform_prop_bwd", KITTI_H, wide, RADIUS))
    check_strip_shape(("deform_prop", KITTI_H, KITTI_W, None))   # the whole-width route
    log(f"[ws] (0) the kernels at the strips' shapes, B={WS_B}, against their plain "
        f"versions: " + ", ".join(f"{k[0]} {k[1]}x{k[2]}" + (
            "" if len(k) == 3 else f" {'exact' if k[3] is None else 'R=' + str(k[3])}")
            for k in sorted(strip_shapes, key=str)))
    ws_dir = tempfile.mkdtemp(prefix="ws-", dir=build.BUILD_DIR)
    try:
        every = {**fwd_wrappers, **bwd_wrappers}
        wants = {}
        for key, (kw, _, trains, _) in WS_RUNS.items():
            cfg_k = Config(**kw)
            if cfg_k.precision == "bf16":
                wants[key] = (expected_bf16_train(cfg_k, 0, 1),
                              expected_bf16_train(cfg_k) if trains else None)
            else:
                wants[key] = ({k: (n if k in fwd_wrappers else 0)
                               for k, n in expected_launches(cfg_k, every).items()},
                              expected_launches(cfg_k, every) if trains else None)
        width_sharding(ws_dir, card, strip_shapes, check_strip_shape, wants)
    finally:
        shutil.rmtree(ws_dir, ignore_errors=True)
    log(f"[ws] phase 17: {time.perf_counter() - t_ws:.1f} s")

    # ---- 18. results ----
    sources = {
        "prop_step": ("nlspn_eccv20_tpu_torch/csrc/prop_step.cu",
                      "nlspn_eccv20_tpu/ops/pallas/local_prop.py:77"),
        "decode_aff_tail": ("nlspn_eccv20_tpu_torch/csrc/dec_aff_tail.cu",
                            "nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py:284"),
        "dep_encode_front": ("nlspn_eccv20_tpu_torch/csrc/dep_encode_front.cu",
                             "nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py:251"),
        "decode_aff_tail_bf16": ("nlspn_eccv20_tpu_torch/csrc/dec_aff_tail_bf16.cu",
                                 "nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py:284"),
        "dep_encode_front_bf16": ("nlspn_eccv20_tpu_torch/csrc/dep_encode_front_bf16.cu",
                                  "nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py:251"),
        "prop_step_bwd": ("nlspn_eccv20_tpu_torch/csrc/prop_step_bwd.cu",
                          "nlspn_eccv20_tpu/ops/pallas/local_prop.py:148"),
        "decode_aff_tail_bwd": ("nlspn_eccv20_tpu_torch/csrc/dec_aff_tail_bwd.cu",
                                "nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py:476"),
        "dep_encode_front_bwd": ("nlspn_eccv20_tpu_torch/csrc/dep_encode_front_bwd.cu",
                                 "nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py:405"),
        "decode_aff_tail_bwd_bf16": ("nlspn_eccv20_tpu_torch/csrc/dec_aff_tail_bwd.cu",
                                     "nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py:476"),
        "dep_encode_front_bwd_bf16": ("nlspn_eccv20_tpu_torch/csrc/dep_encode_front_bwd.cu",
                                      "nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py:405"),
        "deform_prop": ("nlspn_eccv20_tpu_torch/csrc/deform_prop.cu",
                        "nlspn_eccv20_tpu/ops/pallas/deform_prop.py:171"),
        "deform_prop_bwd": ("nlspn_eccv20_tpu_torch/csrc/deform_prop_bwd.cu",
                            "nlspn_eccv20_tpu/ops/pallas/deform_prop.py:300"),
        "prop_loop": ("nlspn_eccv20_tpu_torch/csrc/prop_loop.cu",
                      "nlspn_eccv20_tpu/ops/pallas/local_prop.py:174"),
        "prop_loop_bwd": ("nlspn_eccv20_tpu_torch/csrc/prop_loop_bwd.cu",
                          "nlspn_eccv20_tpu/ops/pallas/local_prop.py:413"),
        "small_conv3x3": ("nlspn_eccv20_tpu_torch/csrc/small_conv3x3.cu",
                          "nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py:158"),
        "small_conv3x3_bwd": ("nlspn_eccv20_tpu_torch/csrc/small_conv3x3_bwd.cu",
                              "nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py:188"),
        "small_conv3x3_bf16": ("nlspn_eccv20_tpu_torch/csrc/small_conv3x3_bf16.cu",
                               "nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py:158"),
        "small_conv3x3_bwd_bf16": ("nlspn_eccv20_tpu_torch/csrc/small_conv3x3_bwd_bf16.cu",
                                   "nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py:188"),
        "deform_windowed": ("nlspn_eccv20_tpu_torch/csrc/deform_windowed.cu",
                            "devtools/exp_deform_prop_kernel.py:95"),
        "deform_colgather": ("nlspn_eccv20_tpu_torch/csrc/deform_colgather.cu",
                             "devtools/exp_deform3.py:26"),
        "gather_probe": ("nlspn_eccv20_tpu_torch/csrc/gather_probe.cu",
                         "devtools/exp_deform2.py:26"),
        "interleave_asm": ("nlspn_eccv20_tpu_torch/csrc/interleave_asm.cu",
                           "devtools/microbench_interleave.py:81"),
        "interleave_strided": ("nlspn_eccv20_tpu_torch/csrc/interleave_strided.cu",
                               "devtools/microbench_asm.py:65"),
        "tile_repeat_probe": ("nlspn_eccv20_tpu_torch/csrc/tile_repeat_probe.cu",
                              "devtools/microbench_asm.py:73"),
        "interleave_onehot": ("nlspn_eccv20_tpu_torch/csrc/interleave_onehot.cu",
                              "devtools/microbench_asm.py:88"),
    }
    path_launches = {**launches, **{k: train_launches[k] for k in bwd_wrappers},
                     "deform_prop": offset_launches["deform_prop"],
                     "deform_prop_bwd": offset_train_launches["deform_prop_bwd"],
                     "prop_loop": loop_launches["prop_loop"],
                     "prop_loop_bwd": loop_train_launches["prop_loop_bwd"],
                     **{k: bf16_launches[k] for k in bf16_wrappers},
                     **{k: bt_launches[k] for k in ("decode_aff_tail_bwd_bf16",
                                                    "dep_encode_front_bwd_bf16")},
                     **oplib_launches,
                     **{k: devtools_launches[k] for k in
                        ("deform_windowed", "deform_colgather", "gather_probe")},
                     **micro_launches}
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
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


DP_RANKS = 2
DP_TIMEOUT = 480          # seconds, each rank subprocess and the torchrun run


def path_wrappers():
    """The kernel wrappers of the default and offset configurations' paths,
    by name: K1, K7, K2, K3 and their backwards, in f32 and bf16."""
    from nlspn_eccv20_tpu_torch.ops.kernels import (
        dec_aff_tail, deform_prop, dep_encode_front, prop_step)

    return {n: getattr(m, n) for m, names in (
        (prop_step, ("prop_step", "prop_step_bwd")),
        (deform_prop, ("deform_prop", "deform_prop_bwd")),
        (dec_aff_tail, ("decode_aff_tail", "decode_aff_tail_bf16", "decode_aff_tail_bwd",
                        "decode_aff_tail_bwd_bf16")),
        (dep_encode_front, ("dep_encode_front", "dep_encode_front_bf16",
                            "dep_encode_front_bwd", "dep_encode_front_bwd_bf16")))
        for n in names}


def dp_steps(cfg_kw, rows):
    """Phase 16's step: ``checked_steps`` of ``Config(**cfg_kw)`` on
    ``rows`` of phase 7's first batch (global: 12 of 228x304), then the
    median of 5 more steps."""
    import numpy as np

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic

    cfg = Config(**cfg_kw)
    full = Synthetic(cfg, "train").batch(list(range(TRAIN_B)), np.random.default_rng(5))
    return checked_steps(cfg, {k: v[rows] for k, v in full.items()}, timed=5)


def checked_steps(cfg, images, evaluate=False, train=True, timed=0, cudnn_on=True,
                  off_scale=None):
    """``cfg``'s Engine on the card from seed 4's random weights, on
    ``images`` (NHWC host arrays; a width-sharded rank keeps its strip),
    with the deterministic algorithms cuDNN's heuristics pick (the step's
    benchmark mode left out, so that every run picks the same ones): with
    ``evaluate`` the eval forward (its pred, whole, and metric rows on the
    host), with ``train`` one train step (the loss, every gradient, the
    weights and running statistics after it, on the host); the launches of
    each kernel wrapper in each, and the strips' exchanges (all-gathers)
    with the bytes this rank sends; then the median of ``timed`` more steps
    as ``Engine.train_step`` runs them (cuDNN's benchmark mode; CUDA
    events). Without ``cudnn_on`` the checked calls run PyTorch's own
    convolutions instead of cuDNN's. With ``offset`` the route of the offset
    steps on a strip (``offset_route``) of each and max |dx| of the eval
    forward's offsets on this rank's columns; ``off_scale`` scales the
    offset head's offset channels first."""
    import contextlib

    import torch

    import nlspn_eccv20_tpu_torch.parallel.halo as halo_mod
    import nlspn_eccv20_tpu_torch.train as train_mod

    from nlspn_eccv20_tpu_torch.train import Engine
    from nlspn_eccv20_tpu_torch.utils.weights import randomize_

    wrappers = path_wrappers()
    traffic = [0, 0]
    all_gather = halo_mod._all_gather

    def counted_gather(t, strips):
        traffic[0] += 1
        traffic[1] += t.numel() * t.element_size()
        return all_gather(t, strips)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        traffic[:] = [0, 0]
        halo_mod._all_gather = counted_gather
        try:
            res = fn()
        finally:
            halo_mod._all_gather = all_gather
        return res, {**{k: w.launches for k, w in wrappers.items()},
                     "exchanges": traffic[0], "exchange_bytes": traffic[1]}

    eng = Engine(cfg, steps_per_epoch=100)
    randomize_(eng.model, torch.Generator().manual_seed(4))
    if off_scale is not None:
        with torch.no_grad():
            head = eng.model.off_aff_dec0[0]
            for p in (head.weight, head.bias):
                p[:2 * cfg.num_neighbors] *= off_scale
    model = eng.init_state()
    batch = eng.put_train_batch(images)
    out = {"width": int(batch["rgb"].shape[3])}
    benchmark_mode = train_mod.cudnn_benchmark_mode
    train_mod.cudnn_benchmark_mode = contextlib.nullcontext
    cudnn = torch.backends.cudnn
    try:
        with cudnn.flags(enabled=cudnn_on, benchmark=False, deterministic=True,
                         allow_tf32=False):
            if evaluate:
                ev, out["eval_launches"] = counted(lambda: eng.eval_step(batch))
                out["pred"] = eng.whole(ev["output"]["pred"]).cpu()
                out["metric"] = ev["metric"].cpu()
                if cfg.offset:
                    out["eval_route"] = model.offset_route
                    out["off_dx_max"] = ev["output"]["offset"][:, 1::2].abs().max().item()
            if train:
                aux, out["launches"] = counted(lambda: eng.train_step(batch))
                out["route"] = model.offset_route
                out.update(loss=aux["loss"].item(),
                           grads={n: p.grad.cpu() for n, p in model.named_parameters()
                                  if p.grad is not None},
                           after={k: v.cpu() for k, v in model.state_dict().items()})
    finally:
        train_mod.cudnn_benchmark_mode = benchmark_mode
    if timed:
        eng.train_step(batch)      # cuDNN times its algorithms
        ms = []
        for _ in range(timed):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng.train_step(batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        out["median_ms"] = sorted(ms)[len(ms) // 2]
    return out


def dp_rank(workdir):
    """One rank of phase 16 (a): joins the gloo group its environment
    describes on the one card, takes the f32 and the bf16 step on its half
    of the global batch, saves what it saw to ``<workdir>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.parallel.mesh import maybe_initialize_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not maybe_initialize_distributed(Config(), backend="gloo"):
        raise SystemExit("dp-rank: no process group in the environment")
    r, n = dist.get_rank(), dist.get_world_size()
    per = TRAIN_B // n
    rows = list(range(r * per, (r + 1) * per))
    res = {"backend": dist.get_backend(), "world": n, "device": torch.cuda.current_device(),
           "f32": dp_steps({}, rows), "bf16": dp_steps({"precision": "bf16"}, rows)}
    torch.save(res, os.path.join(workdir, f"rank{r}.pt"))
    dist.destroy_process_group()
    return 0


def run_with_timeout(cmd, timeout, env=None, cwd=None):
    """Start ``cmd`` in its own process group; (exit code, output). On the
    time limit every process of the group is killed and it raises."""
    import signal

    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{cmd[:4]}...: killed after {timeout} s")
    return proc.returncode, out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def data_parallel(workdir, dev, card, phase7_ms, want_f32, want_bf16):
    """Phase 16. (a) Two gloo ranks on the one card (two subprocesses of
    this script, torchrun's variables set here) each take the default
    configuration's f32 step, then its bf16 step, on 6 of phase 7's 12
    images, from the same random weights; held against the one-process
    step here on all 12 at phase 7's bars (f32: loss 1e-4, each gradient
    5e-3 relative L2; bf16: phase 15's bars), their weights and running
    statistics equal bits after the step, launches 12/11/11 forward and
    backward on each rank; the rank step's median beside the one-process
    step's. (b) ``torchrun --nproc_per_node 1 -m nlspn_eccv20_tpu_torch.main``
    on the synthetic scenes: an NCCL group of one rank, the synchronised
    BatchNorm and the rank-0 writers on the card; it must exit 0."""
    import torch

    def dist_of(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    one = {"f32": dp_steps({}, list(range(TRAIN_B))),
           "bf16": dp_steps({"precision": "bf16"}, list(range(TRAIN_B)))}
    torch.cuda.empty_cache()
    res, wall = spawn_ranks("--dp-rank", workdir, DP_RANKS, DP_TIMEOUT)
    if any((x["backend"], x["world"], x["device"]) != ("gloo", DP_RANKS, dev.index)
           for x in res):
        raise AssertionError(f"[dp] ranks ran {[(x['backend'], x['world']) for x in res]}")

    for prec, want in (("f32", want_f32), ("bf16", want_bf16)):
        ref = one[prec]
        a, b = (x[prec] for x in res)
        for r, x in enumerate((a, b)):
            got = {k: x["launches"].get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"[dp {prec}] rank {r}: launches {got}, expected {want}")
        for k in a["after"]:
            if not torch.equal(a["after"][k], b["after"][k]):
                raise AssertionError(f"[dp {prec}] the ranks' {k} differ after the step")
        if a["loss"] != b["loss"] or a["grads"].keys() != ref["grads"].keys():
            raise AssertionError(f"[dp {prec}] the ranks' losses or gradient sets differ")
        rel = abs(a["loss"] - ref["loss"]) / abs(ref["loss"])
        if prec == "f32":
            rows = [(dist_of(a["grads"][n], g), 5e-3, n) for n, g in ref["grads"].items()
                    if g.abs().max() > 0]
            loss_bar = 1e-4
        else:   # phase 15's bars: the plain bf16 step's distance from f32 sets them
            f32_grads = one["f32"]["grads"]
            rows = [(dist_of(a["grads"][n], g),
                     min(max(5e-2, 2 * dist_of(g, f32_grads[n])), 0.5), n)
                    for n, g in ref["grads"].items() if g.abs().max() > 0]
            loss_bar = 1e-2
            ratios = [a["grads"][n].norm().item() / ref["grads"][n].norm().item()
                      for _, _, n in rows]
            if not all(3 / 4 <= q <= 4 / 3 for q in ratios):
                raise AssertionError(f"[dp bf16] gradient norms {min(ratios):.4f} to "
                                     f"{max(ratios):.4f} of the one-process step's")
        worst = max(rows, key=lambda row: row[0] / row[1])
        log(f"[dp {prec}] {DP_RANKS} gloo ranks on one card, {TRAIN_B // DP_RANKS} images "
            f"a rank of a global {TRAIN_B} x {REQ_H}x{REQ_W}, against one process on all "
            f"{TRAIN_B} (cuDNN deterministic, by its heuristics): loss {a['loss']:.6f} vs {ref['loss']:.6f} "
            f"(rel {rel:.3e}, bar {loss_bar:.0e}); gradients nearest their bar "
            f"{worst[2]} {worst[0]:.3e} (bar {worst[1]:.3e}), largest "
            f"{max(r[0] for r in rows):.3e}; both ranks' weights and running statistics "
            f"equal bits; launches a rank {({k: v for k, v in want.items() if v})}")
        if not rel <= loss_bar:
            raise AssertionError(f"[dp {prec}] loss rel {rel:.3e} > {loss_bar:.0e}")
        if not worst[0] <= worst[1]:
            raise AssertionError(f"[dp {prec}] gradient {worst[2]}: {worst[0]:.3e} > "
                                 f"{worst[1]:.3e}")
        extra = f"; phase 7's one-process step {phase7_ms:.3f} ms" if prec == "f32" else ""
        log(f"[dp {prec}] train step median of 5 (CUDA events, cuDNN benchmark mode as "
            f"Engine.train_step runs it): "
            f"rank 0 {a['median_ms']:.3f} ms, rank 1 {b['median_ms']:.3f} ms at "
            f"{TRAIN_B // DP_RANKS} images, both ranks on the one card at once, their "
            f"all-reduces by gloo through the host; one process at {TRAIN_B} images "
            f"{ref['median_ms']:.3f} ms{extra}; {card}")
    log(f"[dp] (a) two ranks: {wall:.1f} s of wall time with their start")

    # (b) the command line under torchrun, NCCL, one rank
    exp = os.path.join(workdir, "exp")
    t0 = time.perf_counter()
    rc, out = run_with_timeout(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
         "--master_port", str(free_port()), "-m", "nlspn_eccv20_tpu_torch.main",
         "--data_name", "Synthetic", "--test_pipeline", "--epochs", "1",
         "--experiments_dir", exp, "--save", "dp"],
        DP_TIMEOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[dp] torchrun main exited {rc}:\n{out[-4000:]}")
    runs = os.listdir(exp)
    for need in ("data parallel: 1 ranks (nccl on cuda)",
                 f"train epoch 1: {TRAIN_B} images in", "test epoch 0000 | Metric"):
        if need not in out:
            raise AssertionError(f"[dp] torchrun main: no '{need}' in its output")
    if len(runs) != 1 or not all(os.path.exists(os.path.join(exp, runs[0], f)) for f in (
            "args.json", "metric_val.txt", "metric_test.txt",
            os.path.join("ckpt", "model_00001.pt"))):
        raise AssertionError(f"[dp] torchrun main: artifacts {runs}")
    log(f"[dp] (b) torchrun --nproc_per_node 1 -m nlspn_eccv20_tpu_torch.main "
        f"--data_name Synthetic --test_pipeline --epochs 1: exit 0 in {wall:.1f} s "
        f"(NCCL, one rank, the synchronised BatchNorm; every artifact written by rank 0)")


WS_B, WS_TIMED = 2, 3     # phase 17: global batch of KITTI-wide images; timed steps
WS_TIMEOUT = 420          # seconds, each group of rank subprocesses
WS_FAR_DX = 800.0         # max |dx| of the far offsets: past any strip of 1216 columns
WS_RUNS = {   # phase 17's runs: key: (config, ranks that run it, that train it, far offsets)
    "f32": ({}, (2, 3), (2,), False),
    "bf16": ({"precision": "bf16"}, (2,), (2,), False),
    "offset f32": ({"offset": True}, (2, 3), (2, 3), False),
    "offset far": ({"offset": True}, (2, 3), (), True),
    "offset bf16": ({"offset": True, "precision": "bf16"}, (2,), (2,), False),
}


def ws_run(cfg_kw, train=True, timed=True, cudnn_on=True, off_scale=None):
    """Phase 17's work in this process (a width-sharded rank, or the
    one-process reference): ``checked_steps`` of ``Config(**cfg_kw)`` at
    240x1216 on 2 synthetic scenes (seed 5), the eval forward and, with
    ``train``, the step, then with ``timed`` the median of ``WS_TIMED``
    more steps; ``off_scale`` scales the offset head's offsets."""
    import numpy as np

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic

    cfg = Config(patch_height=KITTI_H, patch_width=KITTI_W, batch_size=WS_B, **cfg_kw)
    images = Synthetic(cfg, "train").batch(list(range(WS_B)), np.random.default_rng(5))
    return checked_steps(cfg, images, evaluate=True, train=train,
                         timed=WS_TIMED if train and timed else 0, cudnn_on=cudnn_on,
                         off_scale=off_scale)


def ws_rank(workdir):
    """One rank of phase 17: joins the gloo group its environment describes
    on the one card, with as many strips as ranks, and runs the ``WS_RUNS``
    its number of ranks takes (the far-offset scale from
    ``<workdir>/ws.json``); notes every shape the model gave K1, K7, K2, K3
    and K8; saves what it saw to ``<workdir>/rank<r>.pt``."""
    import json

    import torch
    import torch.distributed as dist

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.ops.kernels import deform_prop as dp_mod
    from nlspn_eccv20_tpu_torch.parallel.mesh import maybe_initialize_distributed

    import nlspn_eccv20_tpu_torch.models.nlspn as net

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not maybe_initialize_distributed(Config(), backend="gloo"):
        raise SystemExit("ws-rank: no process group in the environment")
    shapes = set()

    def noted(name, fn, hw):
        def call(x, *args, **kw):
            shapes.add((name, *hw(x.shape)))
            return fn(x, *args, **kw)
        return call

    # the model's calls of K1, K2, K3 (their bf16 forms too): (H, W) of each
    # input plane, NHWC for K2; of K7 and K8 also the radius (None: exact)
    for name, hw in (("prop_step", lambda s: s[-2:]), ("dep_encode_front", lambda s: s[-2:]),
                     ("decode_aff_tail", lambda s: s[1:3])):
        setattr(net, name, noted(name, getattr(net, name), hw))
    k7 = net.deform_prop

    def noted_k7(p, *args, radius=None, **kw):
        shapes.add(("deform_prop", *p.shape[-2:], radius))
        return k7(p, *args, radius=radius, **kw)

    net.deform_prop = noted_k7
    k8 = dp_mod.DeformPropFunction.backward

    def noted_k8(ctx, g):
        if ctx.radius is not None and not ctx.plain:
            shapes.add(("deform_prop_bwd", *g.shape[-2:], ctx.radius))
        return k8(ctx, g)

    dp_mod.DeformPropFunction.backward = staticmethod(noted_k8)
    with open(os.path.join(workdir, "ws.json")) as f:
        far = json.load(f)["off_scale"]
    r, n = dist.get_rank(), dist.get_world_size()
    res = {"backend": dist.get_backend(), "world": n, "device": torch.cuda.current_device()}
    for key, (kw, runs, trains, far_offsets) in WS_RUNS.items():
        if n in runs:
            res[key] = ws_run({"num_spatial_shards": n, **kw}, train=n in trains,
                              timed=n == 2, off_scale=far if far_offsets else None)
    res["shapes"] = sorted(shapes, key=str)
    torch.save(res, os.path.join(workdir, f"rank{r}.pt"))
    dist.destroy_process_group()
    return 0


def spawn_ranks(flag, workdir, n, timeout):
    """``n`` subprocesses of this script (``flag workdir``) as the ranks of
    a gloo group on the one card, torchrun's variables set here; each saves
    ``<workdir>/rank<r>.pt``. Returns their results and the wall time.
    Raises at once when a rank fails (the others, waiting for it in a
    collective, are killed) or at the time limit."""
    import threading

    import torch

    script = os.path.abspath(__file__)
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, script, flag, workdir], env=env,
            cwd=os.path.dirname(script), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    t0, outs = time.perf_counter(), [[] for _ in procs]
    readers = [threading.Thread(target=lambda p=p, o=o: o.append(p.stdout.read()), daemon=True)
               for p, o in zip(procs, outs)]
    for t in readers:
        t.start()
    while True:
        codes = [p.poll() for p in procs]
        late = time.perf_counter() - t0 > timeout
        if late or any(c not in (None, 0) for c in codes):
            for p in procs:
                p.kill()
                p.wait()
            for t in readers:
                t.join(timeout=10)
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            tail = "".join(outs[bad[0] if bad else 0])[-4000:]
            raise AssertionError(
                f"{flag}: rank {bad[0]} of {n} exited {codes[bad[0]]}:\n{tail}" if bad else
                f"{flag}: the {n} ranks did not finish in {timeout} s:\n{tail}")
        if all(c == 0 for c in codes):
            break
        time.sleep(0.2)
    for t in readers:
        t.join(timeout=10)
    res = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=True)
           for r in range(n)]
    for r in range(n):
        os.remove(os.path.join(workdir, f"rank{r}.pt"))
    return res, time.perf_counter() - t0


def ws_ranks(workdir, n):
    """Phase 17's ``n`` rank subprocesses; their results and wall time."""
    res, wall = spawn_ranks("--ws-rank", workdir, n, WS_TIMEOUT)
    if any((x["backend"], x["world"]) != ("gloo", n) for x in res):
        raise AssertionError(f"[ws] ranks ran {[(x['backend'], x['world']) for x in res]}")
    return res, wall


def width_sharding(workdir, card, checked, check_shape, wants):
    """Phase 17: the one-process references here (``WS_RUNS`` without
    strips), then two and three gloo ranks on the one card with as many
    strips of each 240x1216 image (``--ws-rank``), held to them as the
    module's docstring says. ``wants[key]`` are the launches a rank's eval
    forward and train step of run ``key`` must make. Every shape a rank gave
    K1, K7, K2, K3 or K8 must be in ``checked``: the offset eval's halos,
    which depend on the offsets, are predicted from the one-process offsets
    and checked (``check_shape``) before the ranks start; a shape still
    missing when they return is checked then, and named."""
    import json
    import math

    import numpy as np
    import torch

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic
    from nlspn_eccv20_tpu_torch.metrics import evaluate_per_sample
    from nlspn_eccv20_tpu_torch.parallel.mesh import strip_bounds

    def dist_of(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    lipschitz = [0, 1, 4, 5, 6, 7]   # iRMSE, iMAE take 1 / pred near the floor
    one = {}
    for key, (kw, _, trains, far_offsets) in WS_RUNS.items():
        if not far_offsets:
            one[key] = ws_run(kw, train=bool(trains))
            torch.cuda.empty_cache()
    # the far offsets: the head scaled so that max |dx| is WS_FAR_DX
    far = WS_FAR_DX / one["offset f32"]["off_dx_max"]
    one["offset far"] = ws_run(WS_RUNS["offset far"][0], train=False, off_scale=far)
    with open(os.path.join(workdir, "ws.json"), "w") as f:
        json.dump({"off_scale": far}, f)
    # the second one-process references: the f32 steps through PyTorch's own
    # convolutions instead of cuDNN's
    no_cudnn = {key: ws_run(WS_RUNS[key][0], timed=False, cudnn_on=False)["grads"]
                for key in ("f32", "offset f32")}
    torch.cuda.empty_cache()
    reach_of = {key: 1 + math.ceil(one[key]["off_dx_max"]) + 1
                for key in ("offset f32", "offset far")}
    log(f"[ws] one process: max |dx| of the eval offsets {one['offset f32']['off_dx_max']:.4f} "
        f"(reach {reach_of['offset f32']} columns), far offsets (head x {far:.4e}) "
        f"{one['offset far']['off_dx_max']:.4f} (reach {reach_of['offset far']})")
    for n in (2, 3):   # the offset eval's halos, predicted
        sb = strip_bounds(KITTI_W, n)
        for i in range(n):
            w = sb[i + 1] - sb[i]
            if reach_of["offset f32"] <= min(np.diff(sb)):
                lo, hi = (reach_of["offset f32"] * int(i > 0), reach_of["offset f32"] * int(i < n - 1))
                check_shape(("deform_prop", KITTI_H, w + lo + hi, None))
    scenes = Synthetic(Config(patch_height=KITTI_H, patch_width=KITTI_W, batch_size=WS_B),
                       "train").batch(list(range(WS_B)), np.random.default_rng(5))
    gt = torch.from_numpy(scenes["gt"]).permute(0, 3, 1, 2).contiguous()
    for n in (2, 3):
        res, wall = ws_ranks(workdir, n)
        widths = [x["f32"]["width"] for x in res]
        bounds = strip_bounds(KITTI_W, n)
        if widths != [b - a for a, b in zip(bounds, bounds[1:])]:
            raise AssertionError(f"[ws] {n} ranks: strips of {widths} columns")
        late = sorted({tuple(t) for x in res for t in x["shapes"]} - checked, key=str)
        for shape in late:
            check_shape(shape)
        if late:
            log(f"[ws {n}] shapes the ranks gave their kernels that were not predicted, "
                f"checked now against their plain versions: {late}")
        seams = [c for b in bounds[1:-1] for c in range(b - 8, b + 8)]
        keys = [k for k, (_, runs, _, _) in WS_RUNS.items() if n in runs]
        for key in keys:
            for r, x in enumerate(res):
                got = {k: x[key]["eval_launches"].get(k, 0) for k in wants[key][0]}
                if got != wants[key][0]:
                    raise AssertionError(f"[ws {n} {key}] rank {r}: eval launches {got}, "
                                         f"expected {wants[key][0]}")

        def gap(key):
            """The gathered ``key`` pred (equal on every rank) against
            one process's, of max |pred|: everywhere, and on the 16
            columns around each seam."""
            pred, want = res[0][key]["pred"], one[key]["pred"]
            if pred.shape != want.shape:
                raise AssertionError(f"[ws {n} {key}] pred {tuple(pred.shape)}, "
                                     f"expected {tuple(want.shape)}")
            if not all(torch.equal(x[key]["pred"], pred) for x in res):
                raise AssertionError(f"[ws {n} {key}] the ranks' gathered preds differ")
            d = (pred.float() - want.float()).abs() / max(want.float().abs().max().item(), 1.0)
            return d.max().item(), d[..., seams].max().item()

        for key in keys:
            e0 = res[0][key]
            route = ""
            if key.startswith("offset"):   # the route of the eval's offset steps
                reach = 1 + math.ceil(max(x[key]["off_dx_max"] for x in res)) + 1
                want_route = ("halo" if reach <= min(widths) else "whole", reach)
                routes = [tuple(x[key]["eval_route"]) for x in res]
                if routes != [want_route] * n or (key == "offset far") != (reach > min(widths)):
                    raise AssertionError(f"[ws {n} {key}] eval routes {routes}, expected "
                                         f"{want_route}")
                route = f"; offset steps on {want_route[0]} ({reach} columns reached)"
            fwd, fwd_seam = gap(key)
            if key.endswith("bf16"):
                log(f"[ws eval {key}] {n} gloo ranks, strips of {widths} columns: gathered "
                    f"bf16 pred max |diff| {fwd:.3e} of max |pred| of the one-process bf16 "
                    f"forward (bar 1e-2, the bf16 forward's; {fwd_seam:.3e} on the 16 columns "
                    f"around each seam), equal on every rank{route}")
                if not fwd <= 1e-2:
                    raise AssertionError(f"[ws {n} {key}] eval pred {fwd:.3e} > 1e-2")
                continue
            pred, rows = e0["pred"], e0["metric"]
            want_rows = one[key]["metric"]
            lip = ((rows[:, lipschitz] - want_rows[:, lipschitz]).abs().max()
                   / want_rows[:, lipschitz].abs().max()).item()
            own = evaluate_per_sample({"gt": gt}, {"pred": pred})
            sums = ((rows - own).abs() / own.abs().clamp_min(1e-30)).max().item()
            log(f"[ws eval {key}] {n} gloo ranks on one card, strips of {widths} columns of "
                f"{WS_B} x {KITTI_H}x{KITTI_W}: gathered pred max |diff| {fwd:.3e} of the "
                f"one-process forward (bar 2e-4; {fwd_seam:.3e} on the 16 columns around "
                f"each seam), equal on every rank; metric rows "
                f"(RMSE, MAE, REL, deltas) {lip:.3e} (bar 1e-4), every row against the "
                f"metrics of the gathered pred {sums:.3e} (bar 1e-4); launches a rank "
                f"{({k: v for k, v in wants[key][0].items() if v})}; halo exchanges a rank "
                f"{e0['eval_launches']['exchanges']} (the forward's halos), "
                f"{e0['eval_launches']['exchange_bytes'] / 2**20:.2f} MiB sent by "
                f"rank 0{route}")
            if not (fwd <= 2e-4 and lip <= 1e-4 and sums <= 1e-4):
                raise AssertionError(f"[ws {n} {key}] eval: pred {fwd:.3e}, rows {lip:.3e} / "
                                     f"{sums:.3e}")
        for key in keys:
            if n not in WS_RUNS[key][2]:
                continue
            want = wants[key][1]
            ref_p = one[key]
            for r, x in enumerate(res):
                got = {k: x[key]["launches"].get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(f"[ws {n} {key}] rank {r}: launches {got}, "
                                         f"expected {want}")
            a = res[0][key]
            route = ""
            if key.startswith("offset"):   # the windowed backward's reach
                want_route = ("halo", 1 + RADIUS + 1)
                routes = [tuple(x[key]["route"]) for x in res]
                if routes != [want_route] * n:
                    raise AssertionError(f"[ws {n} {key}] train routes {routes}, expected "
                                         f"{want_route}")
                route = f"; offset steps on a halo of {want_route[1]} columns"
            for x in res[1:]:
                for k in a["after"]:
                    if not torch.equal(a["after"][k], x[key]["after"][k]):
                        raise AssertionError(f"[ws {n} {key}] the ranks' {k} differ after "
                                             f"the step")
                if x[key]["loss"] != a["loss"]:
                    raise AssertionError(f"[ws {n} {key}] the ranks' losses differ")
            if a["grads"].keys() != ref_p["grads"].keys():
                raise AssertionError(f"[ws {n} {key}] the gradient sets differ")
            rel = abs(a["loss"] - ref_p["loss"]) / abs(ref_p["loss"])
            if not key.endswith("bf16"):   # 5e-3 from the nearer of the two one-process steps
                other = no_cudnn[key]
                near = {k: (dist_of(a["grads"][k], g), dist_of(a["grads"][k], other[k]))
                        for k, g in ref_p["grads"].items() if g.abs().max() > 0}
                rows_ = [(min(d), 5e-3, k) for k, d in near.items()]
                loss_bar = 1e-4
                within = [sum(d[i] <= 5e-3 for d in near.values()) for i in (0, 1)]
                farthest = ", ".join(
                    f"{k} {near[k][0]:.3e} / {near[k][1]:.3e} (the two steps "
                    f"{dist_of(other[k], ref_p['grads'][k]):.3e} apart)"
                    for k in sorted(near, key=lambda k: -near[k][0])[:3])
            else:   # phase 15's bars, as phase 16 takes them
                f32_grads = one[key.replace("bf16", "f32")]["grads"]
                rows_ = [(dist_of(a["grads"][k], g),
                          min(max(5e-2, 2 * dist_of(g, f32_grads[k])), 0.5), k)
                         for k, g in ref_p["grads"].items() if g.abs().max() > 0]
                loss_bar = 1e-2
                ratios = [a["grads"][k].norm().item() / ref_p["grads"][k].norm().item()
                          for _, _, k in rows_]
                if not all(3 / 4 <= q <= 4 / 3 for q in ratios):
                    raise AssertionError(f"[ws {n} {key}] gradient norms {min(ratios):.4f} to "
                                         f"{max(ratios):.4f} of the one-process step's")
            worst = max(rows_, key=lambda row: row[0] / row[1])
            if not key.endswith("bf16"):
                log(f"[ws {key}] {n} ranks: gradients within 5e-3 relative L2 of one "
                    f"process's step through cuDNN: {within[0]} of {len(near)}, through "
                    f"PyTorch's own convolutions: {within[1]}; each held at 5e-3 from the "
                    f"nearer; farthest from the cuDNN step (cuDNN / PyTorch's own): {farthest}")
            log(f"[ws {key}] {n} gloo ranks on one card, strips of {widths} columns of "
                f"{WS_B} x {KITTI_H}x{KITTI_W}, against one process (cuDNN deterministic, "
                f"by its heuristics): loss {a['loss']:.6f} vs {ref_p['loss']:.6f} (rel "
                f"{rel:.3e}, bar {loss_bar:.0e}); gradients nearest their bar {worst[2]} "
                f"{worst[0]:.3e} (bar {worst[1]:.3e}), largest {max(r[0] for r in rows_):.3e}; "
                f"every rank's weights and running statistics equal bits; launches a rank "
                f"{({k: v for k, v in want.items() if v})}; halo exchanges in the step "
                f"{a['launches']['exchanges']}, "
                f"{a['launches']['exchange_bytes'] / 2**20:.2f} MiB sent by rank 0{route}")
            if not rel <= loss_bar:
                raise AssertionError(f"[ws {n} {key}] loss rel {rel:.3e} > {loss_bar:.0e}")
            if not worst[0] <= worst[1]:
                raise AssertionError(f"[ws {n} {key}] gradient {worst[2]}: {worst[0]:.3e} > "
                                     f"{worst[1]:.3e}")
            if n == 2:
                b = res[1][key]
                log(f"[ws {key}] train step median of {WS_TIMED} (CUDA events, cuDNN "
                    f"benchmark mode as Engine.train_step runs it): rank 0 "
                    f"{a['median_ms']:.3f} ms, rank 1 {b['median_ms']:.3f} ms, each a strip "
                    f"({widths} columns) of {WS_B} images, both ranks sharing the one card, "
                    f"their halo exchanges and all-reduces by gloo through the host: not a "
                    f"multi-card time; one process on the whole images "
                    f"{ref_p['median_ms']:.3f} ms; {card}")
        log(f"[ws] ({'a' if n == 2 else 'b'}) {n} ranks: {wall:.1f} s of wall time with "
            f"their start")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--ws-rank"]:
        sys.exit(ws_rank(sys.argv[2]))
    sys.exit(main())
