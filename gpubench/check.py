"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``limits/<workload>.json``).

Training: each step's loss, each leaf's first gradient (as Adam got it)
and each leaf's change over the compared steps, the program's against the
reference's. Loss by its relative gap; a leaf by its gap of norms,
|program's norm - reference's|, over the larger of the reference's norm
of that leaf and of the median leaf. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone under
Adam; they are left out of the change.

Serving: each compared answer's depth, by its largest gap over the span of
the traffic's depth range, so that a gap counts alike at every pixel.

Both: every depth the comparison reads (the program's and the reference's
answers; the reference's predictions of the first training step, whose
gradient is compared) has to lie inside [0, far end of the traffic's
depth range]: a depth beyond it means the weights make the propagation
amplify, where the loss clips it and a gap reads nothing. The lower end
is 0, not the range's near end: the depth head starts near its bias, and
``conf_prop`` scales unobserved depth down at every step. Later training
steps are not held to it: Adam's first updates move every weight by about
lr, a large share of the small head weights, and on some seeds turn a few
affinities negative.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np

NEGLIGIBLE = 1e-3


def _gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    floor = statistics.median(ref[n] for n in names)
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], floor) for n in names}


def depth_excess(maps, depth_range) -> float:
    """How far the farthest depth of ``maps`` lies outside [0, far end of
    ``depth_range``], over the range's span; 0 where all lie inside."""
    lo, hi = depth_range
    worst = 0.0
    for m in maps:
        m = np.asarray(m)
        if m.size == 0 or not np.isfinite(m).all():
            return float("inf")
        worst = max(worst, float(m.max()) - hi, -float(m.min()))
    return worst / (hi - lo)


def train_numbers(prog: Dict, ref: Dict,
                  depth_range=None) -> Tuple[Dict[str, float], List[str]]:
    """(numbers, notes) of two ``readings``: ``loss_gap`` (the first
    step's loss) and ``loss_gap_all_steps``; the first gradient's worst and
    median leaf (``grad_gap_worst``, ``grad_gap_median``); the change's
    median and worst leaf (``change_gap_median``, ``change_gap_worst``);
    with ``depth_range``, ``depth_excess`` of the reference's first-step
    predictions.
    A cell's limits file names the ones it compares; after Adam's first
    update (about +-lr on every element, its sign a coin toss where a
    gradient is near 0) two float32 computations part ways, and a worst
    leaf can sit on a sum that cancels, so some read rounding only."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    grad = _gaps(prog["grad"], ref["grad"], list(ref["grad"]))
    median_grad = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= NEGLIGIBLE * median_grad]
    change = _gaps(prog["change"], ref["change"], moved)
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    numbers = {"loss_gap": losses[0], "loss_gap_all_steps": max(losses),
               "grad_gap_worst": grad[worst_grad],
               "grad_gap_median": statistics.median(grad.values()),
               "change_gap_median": statistics.median(change.values()),
               "change_gap_worst": change[worst_change]}
    if depth_range is not None:
        numbers["depth_excess"] = depth_excess(
            [ref["pred_range"]], depth_range)
    notes = [f"losses {prog['loss']} reference {ref['loss']}",
             f"worst gradient leaf {worst_grad}, worst change leaf {worst_change}; "
             f"{len(ref['grad']) - len(moved)} of {len(ref['grad'])} leaves left out "
             f"of the change (gradient under {NEGLIGIBLE} of the median leaf's)",
             "readings: " + ", ".join(f"{k} {v:.4g}" for k, v in numbers.items())]
    return numbers, notes


def depth_gap(prog: List[np.ndarray], ref: List[np.ndarray], depth_range) -> float:
    """The largest |program - reference| at any pixel of the compared depth
    maps, over the span of the traffic's depth range."""
    lo, hi = depth_range
    gaps = []
    for a, b in zip(prog, ref):
        if a.shape != b.shape or not np.isfinite(a).all():
            return float("inf")
        gaps.append(float(np.abs(a - b).max()))
    return max(gaps) / (hi - lo)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {value, limit}}) over the numbers ``limits`` names:
    every one at or under its limit (a number that is not finite fails)."""
    checks = {n: {"value": numbers[n], "limit": lim} for n, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
