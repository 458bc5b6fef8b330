"""Run one cell of the benchmark of the PyTorch/CUDA port of NLSPN once.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``nlspn_eccv20_tpu_torch``), on a machine with as many CUDA
cards as the cell asks for; without them it exits with 1 and prints no
result. The run sets up (builds the cell's kernels into the checkout's
``build/`` where they are not built yet, makes weights and inputs from the
seed), warms up the cell's own shapes, measures for ``--seconds``, then
compares what the timed path produced with the plain reference
(``reference/``) and prints, as the last lines of standard error, each
number compared beside its limit, and as the last line of standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s`` of the
profiled sub-window), with ``--trace 1`` ``breakdown``, and last
``checks``. A run that finds JAX or the JAX package loaded once the
window has closed exits with 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nlspn_eccv20_tpu")
# caches of compilers the program might use, at fixed places in the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda_cache"}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not bring in."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, card, t_start: float):
    """(result dict, stderr lines) of one run of ``cell`` on ``card``."""
    from gpubench import cells, check

    kind = cell.traffic["kind"]
    run = cells.run_train if kind == "train" else cells.run_serve
    win, dev_trace, spans, numbers, notes = run(cell, seed, seconds, trace, card, t_start)
    if trace:
        reading = cells.Reading(cell, win, dev_trace, spans, card.name)
        wanted = [(m, m.reader.read(reading)) for m in cell.per_layer]
    else:
        wanted = [(m, m.reader.read(win)) for m in cell.end_to_end]
    metrics = {m.name: {"value": v, "unit": m.unit} for m, v in wanted if v is not None}
    notes = notes + [f"{m.name}: nothing to read" for m, v in wanted if v is None]
    judged, checks = check.judge(numbers, cell.limits)
    device = {"platform": "gpu" if card.cuda else "cpu", "kind": card.name, "count": 1,
              "memory_peak_bytes": win.process_peak_bytes}
    out = {"correct": bool(judged and win.failed == 0), "attempted": win.units,
           "failed": win.failed, "metrics": metrics, "device": device}
    if trace and dev_trace is not None:
        device["busy_s"] = dev_trace.busy_s
        device["window_s"] = dev_trace.window_s
        out["breakdown"] = dev_trace.breakdown()
    out["checks"] = checks
    units = "steps" if kind == "train" else "requests"
    lines = notes + [f"window {win.seconds:.3f} s, {win.units} {units}, "
                     f"{win.failed} failed, setup {win.setup_s:.3f} s"]
    lines += [f"check {n}: {c['value']:.6g} (limit {c['limit']:.6g})" for n, c in checks.items()]
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, "build", sub)

    import torch

    from gpubench.bench import load
    from gpubench.cells import Card

    cell, _ = load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 1
    try:
        from nlspn_eccv20_tpu_torch.ops.kernels import build
    except ImportError as err:
        log(f"the port is not in this checkout: {err}")
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = [n for n in cell.config["kernels"][cell.traffic["kind"]] if n in build.kernel_names()]
    built = [n for n in names if not os.path.exists(build.library_path(n))]
    build.build_all(names)
    log(f"{args.workload} seed {args.seed}: {power_limit()}; kernels built now: "
        f"{built or 'none'}")
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             Card("cuda"), T_START)
    found = forbidden_modules()
    if found:
        log(f"modules the port must not load are loaded: {found}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
