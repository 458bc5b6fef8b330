"""Training / evaluation engine on one device (counterpart of
``nlspn_eccv20_tpu/train.py``'s ``Engine``, without the mesh).

One train step: the model in train mode with ``need_inter=False`` (the loss
reads only the final prediction), the weighted loss summed over the batch
and divided by the batch size, backward through the kernels' autograd
Functions (K1b, or K8 with ``offset``, K4 and K5 on the card), then the
optimizer with the per-step LR schedule. cuDNN runs in benchmark mode for
the step's own calls only; the process-wide flag is left as it is.

Usage:
    eng = Engine(cfg, steps_per_epoch=len(loader))   # on the CUDA card
    eng.init_state()                                  # or init_state(state_dict)
    aux = eng.train_step(eng.put_batch(numpy_nhwc_batch))
    rows = eng.eval_step(eng.put_batch(numpy_nhwc_batch))
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.device import cudnn_benchmark_mode
from nlspn_eccv20_tpu_torch.losses import get_loss
from nlspn_eccv20_tpu_torch.metrics import evaluate, evaluate_per_sample
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.utils.optim import make_optimizer, set_lr


class Engine:
    """Owns the model, loss, optimizer and LR schedule, and runs the steps.

    ``device`` is the CUDA card unless the caller passes ``device="cpu"``
    (then every kernel runs its plain PyTorch version)."""

    def __init__(self, cfg: Config, steps_per_epoch: int = 1, device=None):
        self.cfg = cfg
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.loss_fn = get_loss(cfg)
        self.model = get_model(cfg, device)
        self.device = self.model.aff_scale_const.device
        self.optimizer = None
        self.schedule = None
        self.step = 0

    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None):
        """Load ``state_dict`` if given, put the model in train mode and
        start a fresh optimizer at step 0. Returns the model."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.train()
        self.optimizer, self.schedule = make_optimizer(
            self.cfg, self.model.parameters(), self.steps_per_epoch)
        self.step = 0
        return self.model

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """NHWC numpy arrays (rgb, dep, gt) -> NCHW float32 tensors on the
        device."""
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
                .to(self.device).permute(0, 3, 1, 2).contiguous()
                for k in ("rgb", "dep", "gt") if k in batch}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """One optimizer step. Returns {loss, loss_val, metric, lr, output}:
        loss and loss_val divided by the batch size, ``lr`` the rate this
        step used, ``output`` the model's output (detached); with
        ``cfg.offset`` also ``off_max``, max |offset| (for
        ``check_offset_telemetry``)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        gbatch = batch["rgb"].shape[0]
        lr = self.schedule(self.step)
        set_lr(self.optimizer, lr)
        self.optimizer.zero_grad(set_to_none=True)
        with cudnn_benchmark_mode():
            out = self.model(batch, need_inter=False)
            loss_sum, loss_val = self.loss_fn(batch, out)
            loss = loss_sum / gbatch
            loss.backward()
        self.optimizer.step()
        self.step += 1
        out = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in out.items()}
        aux = {"loss": loss.detach(), "loss_val": loss_val.detach() / gbatch,
               "metric": evaluate(batch, out), "lr": lr, "output": out}
        if self.cfg.offset:
            aux["off_max"] = out["offset"].abs().max()
        return aux

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """Eval-mode forward: per-image loss rows (B, terms + 1), metric
        rows (B, 8) and the output. The model goes back to train mode."""
        self.model.eval()
        try:
            with cudnn_benchmark_mode():
                out = self.model(batch)
        finally:
            self.model.train()
        return {"loss_val": self.loss_fn.per_sample(batch, out),
                "metric": evaluate_per_sample(batch, out), "output": out}


def check_offset_telemetry(cfg: Config, off_max: float,
                           batch_idx: Optional[int] = None) -> bool:
    """Warn when learned offsets pass 0.8x the training clamp window.

    Training clamps offsets to [-offset_window, offset_window] while eval
    gathers exactly at any offset, so offsets that escape the window make
    train and eval compute different functions. Call it with a step's
    ``off_max``. Returns True when the warning fired."""
    if not (cfg.offset and cfg.offset_window):
        return False
    if off_max <= 0.8 * cfg.offset_window:
        return False
    where = "" if batch_idx is None else f" at batch {batch_idx}"
    warnings.warn(
        f"max|offset| = {off_max:.2f}{where} exceeds 0.8x the training "
        f"clamp window (offset_window={cfg.offset_window}); if it crosses "
        f"{cfg.offset_window} the train step clamps while eval gathers "
        f"exactly (silent train/eval divergence). Raise offset_window to "
        f"widen the exact regime.", stacklevel=2)
    return True
