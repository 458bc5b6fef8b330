"""Depth-completion metric suite (counterpart of
``nlspn_eccv20_tpu/metrics/__init__.py``).

The 8 metrics of the reference: RMSE, MAE, iRMSE, iMAE (inverse depth), REL
and delta < 1.25^{1,2,3}, over valid pixels (gt > 1e-4). Tensors are NCHW:
``output['pred']`` and ``sample['gt']`` are (B, 1, H, W).
"""

from __future__ import annotations

import torch

METRIC_NAMES = ["RMSE", "MAE", "iRMSE", "iMAE", "REL", "D^1", "D^2", "D^3"]
T_VALID = 1e-4


def _metrics(pred: torch.Tensor, gt: torch.Tensor, dims) -> torch.Tensor:
    mask = gt > T_VALID
    num_valid = torch.sum(mask, dim=dims)
    fmask = mask.to(pred.dtype)

    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    pred_inv = torch.where(pred <= T_VALID, zero, 1.0 / (pred + 1e-8))
    gt_inv = torch.where(gt <= T_VALID, zero, 1.0 / (gt + 1e-8))

    diff = (pred - gt) * fmask
    rmse = torch.sqrt(torch.sum(diff ** 2, dim=dims) / (num_valid + 1e-8))
    mae = torch.sum(torch.abs(diff), dim=dims) / (num_valid + 1e-8)

    diff_inv = (pred_inv - gt_inv) * fmask
    irmse = torch.sqrt(torch.sum(diff_inv ** 2, dim=dims) / (num_valid + 1e-8))
    imae = torch.sum(torch.abs(diff_inv), dim=dims) / (num_valid + 1e-8)

    rel = torch.sum(torch.abs(diff) / (gt + 1e-8) * fmask, dim=dims) / (
        num_valid + 1e-8)

    ratio = torch.maximum(gt / (pred + 1e-8), pred / (gt + 1e-8))
    deltas = [torch.sum((ratio < 1.25 ** p) * fmask, dim=dims) / (num_valid + 1e-8)
              for p in (1, 2, 3)]
    return torch.stack([rmse, mae, irmse, imae, rel] + deltas, dim=-1)


@torch.no_grad()
def evaluate(sample, output) -> torch.Tensor:
    """A (1, 8) tensor of metrics over the whole batch."""
    return _metrics(output["pred"], sample["gt"], (0, 1, 2, 3))[None, :]


@torch.no_grad()
def evaluate_per_sample(sample, output) -> torch.Tensor:
    """A (B, 8) tensor: the metrics of each image on its own."""
    return _metrics(output["pred"], sample["gt"], (1, 2, 3))


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
