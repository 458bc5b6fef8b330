"""Loss library with the reference's weighted-spec DSL.

Counterpart of ``nlspn_eccv20_tpu/losses/__init__.py``: ``"1.0*L1+1.0*L2"``
parses into weighted terms; evaluation returns ``(loss_sum, loss_values)``
with a trailing 'Total' entry. Each term is the per-sample mean over valid
pixels (gt > 1e-4 after clipping to [0, max_depth]), summed over the batch.
The clip is ``torch.minimum(torch.maximum(x, 0), max_depth)``, which splits
the gradient at an exact tie as ``jnp.clip`` does (``torch.clamp`` would
pass all of it), and L1's absolute value passes +1 where pred == gt, as
``jnp.abs`` does (``torch.abs`` passes 0).

Under width shards (``strips``, set by ``train.Engine``) a rank holds a
strip of each image: its term is its own sum over the image's valid-pixel
count (added over the strips' ranks, no gradient), so that the terms of the
strips add up to the per-image mean, and the step's one gradient
all-reduce over every rank stays right (summing the numerators too would
count each strip once a strip).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

T_VALID = 1e-4


def _clip(x: torch.Tensor, max_depth: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                         torch.full_like(x, max_depth))


def _abs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, -x)


def _masked_mean_vec(err: torch.Tensor, mask: torch.Tensor, strips=None) -> torch.Tensor:
    """(B,) per-sample mean over valid pixels; on a strip, the strip's sum
    over the whole image's count."""
    d = torch.sum(err * mask, dim=(1, 2, 3))
    num_valid = torch.sum(mask, dim=(1, 2, 3))
    if strips is not None:
        num_valid = strips.sum(num_valid)
    return d / (num_valid + 1e-8)


def _clipped(pred, gt, max_depth):
    gt_c = _clip(gt, max_depth)
    pred_c = _clip(pred, max_depth)
    return pred_c, gt_c, (gt_c > T_VALID).to(pred_c.dtype)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor, max_depth: float,
            strips=None) -> torch.Tensor:
    pred_c, gt_c, mask = _clipped(pred, gt, max_depth)
    return torch.sum(_masked_mean_vec(_abs(pred_c - gt_c), mask, strips))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor, max_depth: float,
            strips=None) -> torch.Tensor:
    pred_c, gt_c, mask = _clipped(pred, gt, max_depth)
    return torch.sum(_masked_mean_vec((pred_c - gt_c) ** 2, mask, strips))


_LOSS_FNS: Dict[str, Callable] = {"L1": l1_loss, "L2": l2_loss}


def parse_loss_spec(spec: str) -> List[Tuple[float, str]]:
    """Parse ``"1.0*L1+0.5*L2"`` -> [(1.0, 'L1'), (0.5, 'L2')]."""
    terms = []
    for part in spec.split("+"):
        weight, name = part.split("*")
        name = name.strip()
        if name not in _LOSS_FNS:
            raise NotImplementedError(f"unknown loss {name}")
        terms.append((float(weight), name))
    return terms


class LossFunction:
    """Weighted-loss evaluator keyed by the loss spec DSL.

    __call__(sample, output) -> (loss_sum, loss_values) where loss_values is
    a (1, num_terms + 1) tensor [w1*l1, ..., total]. Tensors are NCHW:
    ``output['pred']`` and ``sample['gt']`` are (B, 1, H, W). ``strips``
    (``parallel/halo.Strips``) when they are a strip of each image's
    columns.
    """

    def __init__(self, cfg, strips=None):
        self.cfg = cfg
        self.strips = strips
        self.terms = parse_loss_spec(cfg.loss)
        self.loss_name = [name for _, name in self.terms] + ["Total"]

    def __call__(self, sample, output):
        pred, gt = output["pred"], sample["gt"]
        vals = [weight * _LOSS_FNS[name](pred, gt, self.cfg.max_depth, self.strips)
                for weight, name in self.terms]
        total = torch.zeros((), dtype=pred.dtype, device=pred.device)
        for v in vals:
            total = total + v
        return total, torch.stack(vals + [total])[None, :]

    def per_sample(self, sample, output) -> torch.Tensor:
        """(B, num_terms + 1) per-image weighted loss values (on strips,
        the whole images', on every strip's rank)."""
        pred_c, gt_c, mask = _clipped(output["pred"], sample["gt"],
                                      self.cfg.max_depth)
        errs = {"L1": _abs(pred_c - gt_c), "L2": (pred_c - gt_c) ** 2}
        vals = [weight * _masked_mean_vec(errs[name], mask, self.strips)
                for weight, name in self.terms]
        rows = torch.stack(vals + [sum(vals)], dim=-1)
        return rows if self.strips is None else self.strips.sum(rows)


def get_loss(cfg, strips=None):
    if cfg.model_name != "NLSPN":
        raise NotImplementedError(cfg.model_name)
    return LossFunction(cfg, strips)
