"""Depth-completion metric suite (counterpart of
``nlspn_eccv20_tpu/metrics/__init__.py``).

The 8 metrics of the reference: RMSE, MAE, iRMSE, iMAE (inverse depth), REL
and delta < 1.25^{1,2,3}, over valid pixels (gt > 1e-4). Tensors are NCHW:
``output['pred']`` and ``sample['gt']`` are (B, 1, H, W). On a strip of
each image's columns (``strips``, ``parallel/halo.Strips``) the sums and
the valid count are added over the strips' ranks first.
"""

from __future__ import annotations

import torch

METRIC_NAMES = ["RMSE", "MAE", "iRMSE", "iMAE", "REL", "D^1", "D^2", "D^3"]
T_VALID = 1e-4


def _metric_sums(pred: torch.Tensor, gt: torch.Tensor, dims):
    """The sums the metrics divide by the valid-pixel count: (..., 8) in
    the metrics' order (squared and absolute differences, the same of the
    inverse depths, the relative error, the three delta counts), and that
    count. Sums over several ranks' images add."""
    mask = gt > T_VALID
    num_valid = torch.sum(mask, dim=dims)
    fmask = mask.to(pred.dtype)

    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    pred_inv = torch.where(pred <= T_VALID, zero, 1.0 / (pred + 1e-8))
    gt_inv = torch.where(gt <= T_VALID, zero, 1.0 / (gt + 1e-8))

    diff = (pred - gt) * fmask
    diff_inv = (pred_inv - gt_inv) * fmask
    ratio = torch.maximum(gt / (pred + 1e-8), pred / (gt + 1e-8))
    sums = [torch.sum(diff ** 2, dim=dims), torch.sum(torch.abs(diff), dim=dims),
            torch.sum(diff_inv ** 2, dim=dims), torch.sum(torch.abs(diff_inv), dim=dims),
            torch.sum(torch.abs(diff) / (gt + 1e-8) * fmask, dim=dims)]
    sums += [torch.sum((ratio < 1.25 ** p) * fmask, dim=dims) for p in (1, 2, 3)]
    return torch.stack(sums, dim=-1), num_valid


def metrics_from_sums(sums: torch.Tensor, num_valid: torch.Tensor) -> torch.Tensor:
    """RMSE, MAE, iRMSE, iMAE, REL and the deltas from ``_metric_sums``."""
    per = sums / (num_valid + 1e-8)[..., None]
    return torch.cat([torch.sqrt(per[..., :1]), per[..., 1:2], torch.sqrt(per[..., 2:3]),
                      per[..., 3:]], dim=-1)


def _metrics(pred: torch.Tensor, gt: torch.Tensor, dims) -> torch.Tensor:
    return metrics_from_sums(*_metric_sums(pred, gt, dims))


@torch.no_grad()
def metric_sums(sample, output):
    """The whole batch's ``_metric_sums``: (8,) and the valid count."""
    return _metric_sums(output["pred"], sample["gt"], (0, 1, 2, 3))


@torch.no_grad()
def evaluate(sample, output) -> torch.Tensor:
    """A (1, 8) tensor of metrics over the whole batch."""
    return _metrics(output["pred"], sample["gt"], (0, 1, 2, 3))[None, :]


@torch.no_grad()
def evaluate_per_sample(sample, output, strips=None) -> torch.Tensor:
    """A (B, 8) tensor: the metrics of each image on its own (with
    ``strips``, of the whole images, on every strip's rank)."""
    if strips is None:
        return _metrics(output["pred"], sample["gt"], (1, 2, 3))
    sums, num_valid = _metric_sums(output["pred"], sample["gt"], (1, 2, 3))
    both = strips.sum(torch.cat([sums, num_valid[:, None].to(sums.dtype)], -1))
    return metrics_from_sums(both[:, :-1], both[:, -1])


class MetricFunction:
    """The metric suite as the summaries name it: ``metric_name`` and a
    call that gives the (1, 8) batch metrics."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.metric_name = list(METRIC_NAMES)

    def __call__(self, sample, output) -> torch.Tensor:
        return evaluate(sample, output)


def get_metric(cfg) -> MetricFunction:
    if cfg.model_name != "NLSPN":
        raise NotImplementedError(cfg.model_name)
    return MetricFunction(cfg)
