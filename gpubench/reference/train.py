"""Plain training steps of the reference: forward, loss, autograd's
backward and Adam written out, on the weights ``reference.weights`` makes.

``readings`` returns what the benchmark compares a training cell by: each
step's loss, each leaf's first gradient norm and each leaf's change after
the steps, as plain floats.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from gpubench.reference.model import PARAM_KINDS, forward, loss, param_specs


def to_nchw(batch: Dict[str, np.ndarray], device, rows=slice(None)) -> Dict[str, torch.Tensor]:
    """A batch of NHWC numpy arrays as NCHW tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k][rows]))
            .to(device).permute(0, 3, 1, 2) for k in ("rgb", "dep", "gt")}


def readings(c, weights: Dict[str, torch.Tensor], batches: List[Dict[str, np.ndarray]],
             opt: Dict, tf32: bool = False, rows=slice(None)) -> Dict:
    """Run len(batches) Adam steps (lr ``opt['lr']``, betas, eps, no weight
    decay) of the reference from ``weights`` and return {loss: [per step],
    grad: {leaf: norm of its first gradient}, change: {leaf: norm of its
    change after the steps}, pred_range: [least, largest depth the first
    step predicts]}. ``rows`` takes part of each batch (a fault
    that leaves rows out: the mean is then over the rest)."""
    names = [n for n, _, kind, _ in param_specs(c) if kind in PARAM_KINDS]
    p = {n: t.detach().clone() for n, t in weights.items()}
    start = {n: p[n].clone() for n in names}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    b1, b2 = opt["betas"]
    losses, grad_norms, pred_range = [], {}, []
    for t, batch in enumerate(batches, 1):
        for n in names:
            p[n].requires_grad_(True)
        x = to_nchw(batch, next(iter(p.values())).device, rows)
        pred = forward(p, c, x["rgb"], x["dep"], train=True, tf32=tf32)
        if t == 1:
            pred_range = [float(pred.detach().min()), float(pred.detach().max())]
        value = loss(pred, x["gt"], c)
        grads = torch.autograd.grad(value, [p[n] for n in names])
        losses.append(value.detach())
        with torch.no_grad():
            for n, g in zip(names, grads):
                if t == 1:
                    grad_norms[n] = g.norm()
                p[n] = p[n].detach()
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(opt["eps"])
                p[n] = p[n] - (opt["lr"] / (1 - b1 ** t)) * m[n] / denom
        del grads, value, pred
    change = {n: (p[n] - start[n]).norm() for n in names}
    return {"loss": [float(x) for x in losses],
            "grad": {n: float(x) for n, x in grad_norms.items()},
            "change": {n: float(x) for n, x in change.items()},
            "pred_range": pred_range}
