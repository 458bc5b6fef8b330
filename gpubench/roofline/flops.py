"""Model FLOPs of a cell, counted by ``torch.utils.flop_counter`` over the
reference model at the cell's shapes.

The count runs on the ``meta`` device: shapes only, no memory, no card. It
takes what the counter knows (convolutions, transposed convolutions and
their backwards, matrix products), which is where the model's arithmetic
is; the propagation's and the elementwise work's operations are not in it.
A training step counts the forward and autograd's backward of the loss,
nothing recomputed; serving counts the eval forward at the bucket's
shape, padding included, which is the work the model does. The
propagation steps, which hold none of the counted operations, are stood
in for by one product of the same inputs, so that the count takes a
second.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.reference.model import PARAM_KINDS, forward, loss, param_specs


def _stand_in(feat, off, aff):
    y = (feat[:, None] * aff).sum(1)
    return y if off is None else y + 0.0 * off.sum(1)


def model_flops(c, b: int, h: int, w: int, train: bool) -> int:
    """FLOPs of one training step (forward and backward) or one forward on
    a batch of b images of h x w."""
    meta = torch.device("meta")
    p = {}
    for name, shape, kind, _ in param_specs(c):
        t = torch.empty(shape, device=meta,
                        dtype=torch.int64 if kind == "count" else torch.float32)
        p[name] = t.requires_grad_(train and kind in PARAM_KINDS)
    rgb = torch.empty(b, 3, h, w, device=meta)
    dep = torch.empty(b, 1, h, w, device=meta)
    counter = FlopCounterMode(display=False)
    with counter:
        pred = forward(p, c, rgb, dep, train=train, propagate=_stand_in)
        if train:
            loss(pred, torch.empty_like(pred), c).backward()
    return counter.get_total_flops()
