"""Experiment summaries: scalars, text logs, TensorBoard, image artifacts
(counterpart of ``nlspn_eccv20_tpu/summary/__init__.py``; the files on disk
are the same bytes).

* Epoch means of the loss and metric rows go to the console and to the
  append-only ``loss_{mode}.txt`` / ``metric_{mode}.txt``, and to
  TensorBoard where ``torch.utils.tensorboard`` imports.
* Image grids: rgb | sparse depth | pred | gt | confidence, plasma colormap.
* Test artifacts: KITTI submission PNGs ``uint16(pred * 256)`` with
  ``save_result_only``, else the visualization dumps with per-step
  predictions and offset / aff / gamma ``.npy``.

The model's tensors are NCHW; they are written as NHWC numpy arrays, the
JAX package's layout. Under data parallel only rank 0 holds a ``Summary``
(``main.py``): its rows come from every rank, its images from its own
shard, and its test artifacts from every rank through ``main``. PIL and matplotlib are imported where an image is
written; without matplotlib the TensorBoard image grids are left out.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, List, Optional

import numpy as np

from nlspn_eccv20_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def _host_local(x) -> np.ndarray:
    """``x`` as a host array. A rank's tensors hold its own shard of the
    batch only, so rank 0's image grids show its own images, as the JAX
    package's show its addressable shards; no gather across ranks."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _nhwc(x) -> np.ndarray:
    """A model tensor as a host array, NCHW turned NHWC."""
    a = _host_local(x)
    return np.transpose(a, (0, 2, 3, 1)) if a.ndim == 4 else a


def _unnormalize_rgb(rgb: np.ndarray) -> np.ndarray:
    return np.clip(rgb * IMAGENET_STD + IMAGENET_MEAN, 0, 1)


def _colormap(x: np.ndarray, vmax: float, cmap: str = "plasma") -> np.ndarray:
    """(H, W) -> (H, W, 3) uint8 through a matplotlib colormap."""
    import matplotlib

    norm = np.clip(x / max(vmax, 1e-8), 0, 1)
    return (matplotlib.colormaps[cmap](norm)[..., :3] * 255).astype(np.uint8)


def _tensorboard_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:         # TensorBoard is optional
        return None
    return SummaryWriter(log_dir=log_dir)


class Summary:
    def __init__(self, log_dir: str, mode: str, cfg,
                 loss_name: Optional[List[str]], metric_name: List[str]):
        self.mode = mode
        self.cfg = cfg
        self.loss_name = loss_name
        self.metric_name = metric_name
        self.log_dir = os.path.join(log_dir, mode)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path_output = None

        self._loss: List[np.ndarray] = []
        self._metric: List[np.ndarray] = []
        self._tb = _tensorboard_writer(self.log_dir)

        self.f_loss = (os.path.join(log_dir, f"loss_{mode}.txt")
                       if loss_name is not None else None)
        self.f_metric = os.path.join(log_dir, f"metric_{mode}.txt")

    def add(self, loss=None, metric=None):
        """Accumulate (B, terms + 1) loss rows and (B, 8) metric rows."""
        if loss is not None:
            self._loss.append(_host_local(loss))
        if metric is not None:
            self._metric.append(_host_local(metric))

    def scalar(self, name: str, value: float, epoch: int):
        """An ad-hoc TensorBoard scalar (e.g. Etc/max_offset)."""
        if self._tb:
            self._tb.add_scalar(name, float(value), epoch)

    def update(self, epoch: int, sample=None, output=None) -> Dict[str, float]:
        """Epoch means to the console, the text logs and TensorBoard; the
        image grid of ``sample`` and ``output``. Returns the means."""
        result = {}
        if self._loss and self.loss_name:
            mean = np.concatenate(self._loss, axis=0).mean(axis=0)
            msg = " | ".join(f"{n}: {v:8.4f}" for n, v in zip(self.loss_name, mean))
            print(f"{self.mode} epoch {epoch:04d} | Loss   | {msg}")
            with open(self.f_loss, "a") as f:
                f.write(f"{epoch:04d} | {msg}\n")
            if self._tb:
                for n, v in zip(self.loss_name, mean):
                    self._tb.add_scalar(f"Loss/{n}", float(v), epoch)
            result.update({f"loss/{n}": float(v) for n, v in zip(self.loss_name, mean)})
        if self._metric:
            mean = np.concatenate(self._metric, axis=0).mean(axis=0)
            msg = " | ".join(f"{n}: {v:9.5f}" for n, v in zip(self.metric_name, mean))
            print(f"{self.mode} epoch {epoch:04d} | Metric | {msg}")
            with open(self.f_metric, "a") as f:
                f.write(f"{epoch:04d} | {msg}\n")
            if self._tb:
                for n, v in zip(self.metric_name, mean):
                    self._tb.add_scalar(f"Metric/{n}", float(v), epoch)
            result.update({n: float(v) for n, v in zip(self.metric_name, mean)})

        if self._tb and output is not None and output.get("gamma") is not None:
            gamma = float(_host_local(output["gamma"]).ravel()[0])
            self._tb.add_scalar("Etc/gamma", gamma, epoch)
        if self._tb and sample is not None and output is not None:
            self._tb_images(epoch, sample, output)

        self._loss.clear()
        self._metric.clear()
        if self._tb:
            self._tb.flush()
        return result

    def _tb_images(self, epoch: int, sample, output):
        if importlib.util.find_spec("matplotlib") is None:   # for the colormaps
            return
        rgb = _nhwc(sample["rgb"])
        n = min(self.cfg.num_summary, rgb.shape[0])
        rgb = _unnormalize_rgb(rgb[:n])
        dep = _nhwc(sample["dep"])[:n, ..., 0]
        gt = _nhwc(sample["gt"])[:n, ..., 0]
        pred = _nhwc(output["pred"])[:n, ..., 0]
        conf = output.get("confidence")
        conf = _nhwc(conf)[:n, ..., 0] if conf is not None else None
        vmax = self.cfg.max_depth
        rows = []
        for i in range(n):
            row = [(rgb[i] * 255).astype(np.uint8), _colormap(dep[i], vmax),
                   _colormap(pred[i], vmax), _colormap(gt[i], vmax)]
            if conf is not None:
                row.append(_colormap(conf[i], 1.0, "gray"))
            rows.append(np.concatenate(row, axis=1))
        self._tb.add_image(f"{self.mode}/images", np.concatenate(rows, axis=0),
                           epoch, dataformats="HWC")

    def setup_output_dir(self, epoch: int):
        self.path_output = os.path.join(self.log_dir, f"epoch{epoch:04d}")
        os.makedirs(self.path_output, exist_ok=True)

    def save(self, epoch: int, idx: int, sample, output, batch_index: int = 0):
        """One image's artifacts: ``epoch%04d/%010d.png`` submission PNGs
        with ``save_result_only``; otherwise a directory ``epoch%04d/%08d/``
        with 01_rgb / 02_dep / 03_pred_init / 04_pred_prop_%02d /
        05_pred_final (+ _gray) / 06_gt PNGs and offset / aff / gamma
        ``.npy``. ``batch_index`` picks the image in the batch."""
        from PIL import Image

        if self.path_output is None:
            self.setup_output_dir(epoch)

        b = batch_index
        pred = np.clip(_nhwc(output["pred"])[b, ..., 0], 0, None)
        if self.cfg.save_result_only:
            # KITTI submission format: 16-bit PNG, clamp(pred) * 256
            img = (pred * 256.0).astype(np.uint16)
            Image.fromarray(img).save(
                os.path.join(self.path_output, f"{idx:010d}.png"))
            return

        out_dir = os.path.join(self.path_output, f"{idx:08d}")
        os.makedirs(out_dir, exist_ok=True)
        vmax = self.cfg.max_depth

        def save_cm(arr, name):
            Image.fromarray(_colormap(arr, vmax)).save(os.path.join(out_dir, name))

        rgb = (_unnormalize_rgb(_nhwc(sample["rgb"])[b]) * 255).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(out_dir, "01_rgb.png"))
        save_cm(_nhwc(sample["dep"])[b, ..., 0], "02_dep.png")
        save_cm(pred, "05_pred_final.png")
        gray = (np.clip(pred / max(vmax, 1e-8), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(gray).save(os.path.join(out_dir, "05_pred_final_gray.png"))
        save_cm(_nhwc(sample["gt"])[b, ..., 0], "06_gt.png")
        if output.get("pred_init") is not None:
            save_cm(_nhwc(output["pred_init"])[b, ..., 0], "03_pred_init.png")
        # an empty list: the per-step predictions were not collected
        for t, p in enumerate(output.get("pred_inter") or []):
            save_cm(_nhwc(p)[b, ..., 0], f"04_pred_prop_{t:02d}.png")
        if output.get("offset") is not None:
            np.save(os.path.join(out_dir, "offset.npy"),
                    _nhwc(output["offset"])[b:b + 1])
        np.save(os.path.join(out_dir, "aff.npy"), _nhwc(output["aff"])[b:b + 1])
        np.save(os.path.join(out_dir, "gamma.npy"), _host_local(output["gamma"]))

    def close(self):
        if self._tb:
            self._tb.close()


def get_summary(cfg, mode: str, loss_name, metric_name) -> Summary:
    return Summary(cfg.save_dir, mode, cfg, loss_name, metric_name)
