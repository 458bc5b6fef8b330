"""Inference / serving surface (counterpart of ``nlspn_eccv20_tpu/serve.py``).

``Predictor`` pads each request up to a multiple of ``bucket`` (rgb by edge
replication, depth with zeros so that padding never counts as an
observation), normalises uint8 rgb with the ImageNet statistics, stacks a
batch, runs the model under ``torch.inference_mode()`` and crops every
prediction back to its request's size.

Usage:
    p = Predictor(cfg, checkpoint="/path/to/experiment_dir")  # on the CUDA card
    depth = p.predict(rgb, sparse_depth)   # (H, W, 3) uint8/float, (H, W)

It needs weights, as the JAX package's does: a ``state_dict``, or a
``checkpoint``, which is a reference or port checkpoint file
(``.pt/.pth/.tar``) or a port experiment directory (its latest
checkpoint). A tool that wants random ones asks for them:
``model = randomize_(get_model(cfg, dev), gen)``, then
``Predictor(cfg, state_dict=model.state_dict(), device=dev)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from nlspn_eccv20_tpu_torch.device import cudnn_benchmark_mode
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.train import load_pretrained_params
from nlspn_eccv20_tpu_torch.utils.checkpoint import load_weights


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Predictor:
    """Shape-bucketed NLSPN inference on one device.

    ``predict_batch`` runs the model in cuDNN's benchmark mode without
    changing the process-wide ``torch.backends.cudnn.benchmark``; a caller
    that runs ``self.model`` directly sets that flag itself. Without a
    ``state_dict`` it raises ``ValueError`` (after building the model, so
    that a missing card is reported first, as the JAX package orders it).
    Weights from a ``checkpoint`` load as ``train.load_pretrained_params``
    loads them: a missing key raises, an extra one warns."""

    def __init__(self, cfg: Config,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 checkpoint: Optional[str] = None,
                 device=None, bucket: int = 32):
        self.cfg = cfg
        self.bucket = bucket
        self.model = get_model(cfg, device)
        self.device = self.model.aff_scale_const.device
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        elif checkpoint is not None:
            load_pretrained_params(self.model, load_weights(cfg, checkpoint))
        else:
            raise ValueError("need `state_dict` or `checkpoint`")

    def _prepare(self, rgb: np.ndarray, dep: np.ndarray):
        """Normalize + pad one (H, W, 3)/(H, W[, 1]) pair to its bucket."""
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float32) / 255.0
            rgb = (rgb - IMAGENET_MEAN) / IMAGENET_STD
        rgb = np.asarray(rgb, np.float32)
        dep = np.asarray(dep, np.float32)
        if dep.ndim == 3:
            dep = dep[..., 0]
        h, w = rgb.shape[:2]
        hb, wb = _round_up(h, self.bucket), _round_up(w, self.bucket)
        rgb_p = np.pad(rgb, ((0, hb - h), (0, wb - w), (0, 0)), mode="edge")
        dep_p = np.pad(dep, ((0, hb - h), (0, wb - w)))
        return rgb_p, dep_p, (h, w)

    def predict(self, rgb: np.ndarray, dep: np.ndarray) -> np.ndarray:
        """One image -> dense depth (H, W) float32."""
        return self.predict_batch([rgb], [dep])[0]

    def make_sample(self, rgbs, deps):
        """Requests -> the model's padded NCHW batch on the device, and the
        request sizes to crop back to."""
        prepped = [self._prepare(r, d) for r, d in zip(rgbs, deps)]
        hb = max(p[0].shape[0] for p in prepped)
        wb = max(p[0].shape[1] for p in prepped)
        rgb = np.stack([np.pad(p[0], ((0, hb - p[0].shape[0]),
                                      (0, wb - p[0].shape[1]), (0, 0)),
                               mode="edge") for p in prepped])
        dep = np.stack([np.pad(p[1], ((0, hb - p[1].shape[0]),
                                      (0, wb - p[1].shape[1])))
                        for p in prepped])
        sample = {
            "rgb": torch.from_numpy(rgb).to(self.device).permute(0, 3, 1, 2),
            "dep": torch.from_numpy(dep).to(self.device)[:, None],
        }
        return sample, [p[2] for p in prepped]

    def predict_batch(self, rgbs, deps) -> list:
        sample, sizes = self.make_sample(rgbs, deps)
        with torch.inference_mode(), cudnn_benchmark_mode():
            pred = self.model(sample, need_inter=False)["pred"][:, 0]
        pred = pred.cpu().numpy()
        return [pred[i, :h, :w] for i, (h, w) in enumerate(sizes)]

    def warmup(self, shapes=((228, 304),)):
        """One request of each (h, w), so that cuDNN has picked its
        algorithms before the first real one."""
        for (h, w) in shapes:
            self.predict(np.zeros((h, w, 3), np.float32),
                         np.zeros((h, w), np.float32))

    def benchmark(self, h: int = 228, w: int = 304, batch: int = 1,
                  calls: int = 20, seed: int = 0) -> Dict[str, float]:
        """Latency of ``predict_batch`` on ``batch`` requests of (h, w), from
        CUDA events around each call (host preparation and both copies
        included), after one warm-up call. Seconds."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark() times the CUDA card; this "
                               f"Predictor runs on {self.device}")
        rng = np.random.default_rng(seed)
        rgbs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for _ in range(batch)]
        deps = [np.where(rng.random((h, w)) < 0.007,
                         rng.uniform(0.5, 10.0, (h, w)), 0.0).astype(np.float32)
                for _ in range(batch)]
        self.predict_batch(rgbs, deps)
        times = []
        for _ in range(calls):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.predict_batch(rgbs, deps)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        times.sort()
        return {"median_s": times[len(times) // 2], "min_s": times[0],
                "mean_s": sum(times) / len(times)}

