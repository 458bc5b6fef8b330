"""The readings the limits of ``correct`` are set from (``limits/``), on the
card, at the cell's own sizes; the benchmark's runs do not run it.

    python3 -m gpubench.calibrate --workload <name> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--bn-seeds ...] \\
        [--rates 10 12 ...] [--seconds 2] [--out FILE]

For each seed the program's own run as ``run`` makes it (a short window;
its numbers are the lower readings). For each control seed, with the same
weights and inputs: the control, the reference in TF32 (cuDNN's and
matmul's TF32 switched on; and the reference's own emulation of it,
``reference.model.round_tf32``) in the program's place; for a training
cell also the fault that leaves half of each batch out (the mean taken
over the rest), and a second float32 witness, the reference with cuDNN's
timed algorithms; ``--bn-seeds`` runs a training cell's program with the
reference's BatchNorm, against the reference.
The fault that leaves the state unchanged reads 1 on the change by its
definition and needs no run. Each reading is one JSON
line; a program's line carries its notes, which hold its further
readings (every step's loss, the worst leaf's change). ``--rates`` sweeps
a serving cell's open-loop rate: each rate's median and 95th-percentile
latency and the mean latency of its first and last quarter of requests,
which part where the backlog grows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gpubench import check, generator
from gpubench.bench import load
from gpubench.cells import (Card, reference_answers, run_serve, run_train, train_program,
                            train_reference)
from gpubench.reference import model as ref_model
from gpubench.reference.train import readings
from gpubench.reference.weights import make_weights
from gpubench.run import ROOT


def tf32_switch(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def control_train(cell, seed: int, card: Card):
    t = cell.traffic
    c = ref_model.load_config(cell.config["config"])
    pool = generator.train_pool(t, seed)[:t["check_steps"]]
    opt = {"lr": t["lr"], "betas": t["betas"], "eps": t["eps"]}
    w = make_weights(c, seed, card.device)
    tf32_switch(False)      # the reference in float32, whatever the process had set
    ref = readings(c, w, pool, opt)
    out = {}
    tf32_switch(True)
    try:
        out["control_tf32"] = readings(c, w, pool, opt)
    finally:
        tf32_switch(False)
    out["control_tf32_emulated"] = readings(c, w, pool, opt, tf32=True)
    out["fault_half_batch"] = readings(c, w, pool, opt, rows=slice(0, t["batch"] // 2))
    # a second float32 witness: the reference with cuDNN's timed algorithms
    torch.backends.cudnn.benchmark = True
    try:
        out["witness_f32_benchmark"] = readings(c, w, pool, opt)
    finally:
        torch.backends.cudnn.benchmark = False
    return {side: check.train_numbers(r, ref, t["depth_range"])[0] for side, r in out.items()}


def bn_witness(cell, seed: int, card: Card, seconds: float):
    """The program with its train-mode BatchNorm computed as the reference
    computes it (the batch mean, then the mean of squared deviations),
    against the float32 reference: whether cuDNN's BatchNorm is what parts
    the program's first gradient from the reference's."""
    from nlspn_eccv20_tpu_torch.models import common

    library = common.BatchNorm.forward

    def explicit(self, x):
        if not self.training:
            return library(self, x)
        mean = x.mean((0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        scale = self.weight / torch.sqrt(var + self.eps)
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]

    common.BatchNorm.forward = explicit
    try:
        _, _, program, _ = train_program(cell, seed, seconds, False, card, time.perf_counter())
    finally:
        common.BatchNorm.forward = library
    card.free()
    ref = train_reference(cell, seed, card)
    return {"witness_explicit_bn": check.train_numbers(program, ref,
                                                       cell.traffic["depth_range"])[0]}


def control_serve(cell, seed: int, card: Card):
    t = cell.traffic
    c = ref_model.load_config(cell.config["config"])
    pool = generator.serve_pool(t, seed)[:t["compare_answers"]]
    w = make_weights(c, seed, card.device)

    def answers(tf32: bool, emulate: bool):
        tf32_switch(tf32)
        try:
            found = reference_answers(c, w, pool, t["bucket"], card.device, tf32=emulate)
            return [m for request in found for m in request]
        finally:
            tf32_switch(False)

    ref = answers(False, False)
    span = t["depth_range"]
    return {side: {"depth_gap": check.depth_gap(found, ref, span),
                   "depth_excess": check.depth_excess(found, span)}
            for side, found in (("control_tf32", answers(True, False)),
                                ("control_tf32_emulated", answers(False, True)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--bn-seeds", type=int, nargs="*", default=[],
                    help="a training cell's seeds to run with the reference's BatchNorm")
    ap.add_argument("--rates", type=float, nargs="*", default=[],
                    help="a serving cell's open-loop rates (Hz) to sweep, one seed each")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "calibrate.jsonl"))
    args = ap.parse_args(argv)
    cell, _ = load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("calibrate reads the card; none is available", file=sys.stderr)
        return 1
    from nlspn_eccv20_tpu_torch.ops.kernels import build

    tf32_switch(False)
    build.build_all([n for n in cell.config["kernels"][cell.traffic["kind"]]
                     if n in build.kernel_names()])
    card = Card("cuda")
    train = cell.traffic["kind"] == "train"
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "a") as f:
        def emit(rec):
            rec.update(workload=args.workload, device=card.name)
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()

        for seed in args.seeds:
            run = run_train if train else run_serve
            win, _, _, numbers, notes = run(cell, seed, args.seconds, False, card,
                                            time.perf_counter())
            emit({"seed": seed, "side": "program", "numbers": numbers, "notes": notes,
                  "units": win.units, "window_s": win.seconds})
            card.free()
        for rate in args.rates:
            cell.traffic["rate_hz"] = rate
            win = run_serve(cell, 1000 + int(rate * 10), args.seconds, False, card,
                            time.perf_counter())[0]
            lat = np.asarray(win.latencies_s) * 1e3
            quarter = max(len(lat) // 4, 1)
            emit({"rate_hz": rate, "side": "sweep", "requests": win.units,
                  "p50_ms": float(np.median(lat)), "p95_ms": float(np.percentile(lat, 95)),
                  "first_quarter_ms": float(lat[:quarter].mean()),
                  "last_quarter_ms": float(lat[-quarter:].mean())})
            card.free()
        for seed in args.bn_seeds:
            for side, numbers in bn_witness(cell, seed, card, args.seconds).items():
                emit({"seed": seed, "side": side, "numbers": numbers})
            card.free()
        for seed in args.control_seeds:
            found = control_train(cell, seed, card) if train else control_serve(cell, seed, card)
            for side, numbers in found.items():
                emit({"seed": seed, "side": side, "numbers": numbers})
            card.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
