"""Training / evaluation engine on one device (counterpart of
``nlspn_eccv20_tpu/train.py``'s ``Engine``, without the mesh).

One train step: the model in train mode with ``need_inter=False`` (the loss
reads only the final prediction), the weighted loss summed over the batch
and divided by the batch size, backward through the kernels' autograd
Functions (K1b, or K8 with ``offset``, K4 and K5 on the card), then the
optimizer with the per-step LR schedule. cuDNN runs in benchmark mode for
the step's own calls only; the process-wide flag is left as it is.

The initial weights are drawn from a generator seeded with ``cfg.seed``
(``utils/weights.init_weights_``), so a run's weights are a function of its
seed alone. ``init_backbone_pretrained`` puts torchvision's ImageNet ResNet
into the encoder stages and ``load_pretrained_params`` merges a
checkpoint's weights into the model, both as the JAX package's do.

Usage:
    eng = Engine(cfg, steps_per_epoch=len(loader))   # on the CUDA card
    eng.init_state()                                  # or init_state(state_dict)
    aux = eng.train_step(eng.put_batch(numpy_nhwc_batch))
    rows = eng.eval_step(eng.put_batch(numpy_nhwc_batch))
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.device import cudnn_benchmark_mode
from nlspn_eccv20_tpu_torch.losses import get_loss
from nlspn_eccv20_tpu_torch.metrics import evaluate, evaluate_per_sample
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.utils.optim import make_optimizer, set_lr
from nlspn_eccv20_tpu_torch.utils.torch_import import load_torchvision_resnet
from nlspn_eccv20_tpu_torch.utils.weights import init_weights_


class Engine:
    """Owns the model, loss, optimizer and LR schedule, and runs the steps.

    ``device`` is the CUDA card unless the caller passes ``device="cpu"``
    (then every kernel runs its plain PyTorch version)."""

    def __init__(self, cfg: Config, steps_per_epoch: int = 1, device=None):
        self.cfg = cfg
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.loss_fn = get_loss(cfg)
        self.model = init_weights_(get_model(cfg, device),
                                   torch.Generator().manual_seed(cfg.seed))
        self.device = self.model.aff_scale_const.device
        self.optimizer = None
        self.schedule = None
        self.step = 0

    @property
    def eval_batch_per_host(self) -> int:
        """The eval batch of this process: 1 on one card, as the JAX
        property gives on a one-device mesh."""
        return 1

    def checkpoint_state(self) -> Dict[str, Any]:
        """{net, optimizer, step, steps_per_epoch}, as
        ``utils/checkpoint.CheckpointManager.save`` takes it; the weights
        copied to the CPU."""
        return {"net": {k: v.detach().cpu()
                        for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "steps_per_epoch": self.steps_per_epoch}

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


def init_backbone_pretrained(cfg: Config, model: torch.nn.Module) -> torch.nn.Module:
    """ImageNet-pretrained encoder stages from torchvision's
    ``{dir_pretrain_backbone}/{network}.pth``, as the reference builds its
    model. ``--from_scratch`` skips it. A file missing under the default
    directory warns (synthetic runs need none); one missing under a
    directory the caller named raises. Nothing is downloaded."""
    if cfg.from_scratch:
        return model
    path = os.path.join(cfg.dir_pretrain_backbone, f"{cfg.network}.pth")
    if not os.path.isfile(path):
        if cfg.dir_pretrain_backbone != Config().dir_pretrain_backbone:
            raise FileNotFoundError(
                f"--dir_pretrain_backbone given but {path} does not exist; "
                f"pass --from_scratch to train without it")
        warnings.warn(
            f"no ImageNet-pretrained backbone at {path}; training the "
            f"{cfg.network} encoder FROM SCRATCH. Published NYUv2/KITTI "
            f"accuracy assumes pretrained weights: put the torchvision "
            f"{cfg.network} state_dict at {path}, or pass --from_scratch to "
            f"silence this warning.", stacklevel=2)
        return model
    stages = load_torchvision_resnet(path, cfg.network)
    own = {k for k in model.state_dict() if k.startswith(("conv2.", "conv3.", "conv4."))}
    missing = own - set(stages)
    if missing:
        raise KeyError(f"{path} lacks {sorted(missing)[:5]}...")
    model.load_state_dict({k: stages[k] for k in own}, strict=False)
    print(f"loaded ImageNet-pretrained {cfg.network} backbone from {path}")
    return model


def load_pretrained_params(model: torch.nn.Module,
                           state_dict: Dict[str, torch.Tensor],
                           strict: bool = False) -> torch.nn.Module:
    """Load a checkpoint's weights into ``model``, as the reference's
    test-time load does: a key the model has and the checkpoint lacks
    raises; a key the model lacks warns (raises with ``strict``)."""
    own = model.state_dict()
    missing = set(own) - set(state_dict)
    unexpected = set(state_dict) - set(own)
    if missing:
        raise KeyError(f"missing params in checkpoint: {sorted(missing)[:5]}...")
    if unexpected:
        if strict:
            raise KeyError(f"unexpected params: {sorted(unexpected)[:5]}...")
        warnings.warn(f"checkpoint params not in the model, ignored: "
                      f"{sorted(unexpected)[:5]}...", stacklevel=2)
    model.load_state_dict({k: state_dict[k] for k in own})
    return model
