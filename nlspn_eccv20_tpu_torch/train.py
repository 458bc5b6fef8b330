"""Training / evaluation engine (counterpart of
``nlspn_eccv20_tpu/train.py``'s ``Engine``), on one device, or data parallel
and width-sharded over the ranks of a process group (``parallel/mesh.py``).

One train step, in f32 or in bf16 (``precision='bf16'``: f32 parameters
and optimizer, bf16 compute, f32 gradients, no loss scaling, as the JAX
package trains): the model in train mode with ``need_inter=False`` (the loss
reads only the final prediction), the weighted loss summed over the batch
and divided by the global batch size, in f32, backward through the kernels'
autograd Functions (K1b, or K8 with ``offset``, K4 and K5 on the card; K4-bf16
and K5-bf16 in bf16), then the optimizer with the per-step LR schedule. cuDNN runs in benchmark mode for
the step's own calls only; the process-wide flag is left as it is.

Data parallel: each rank runs the step on its own shard of the global
batch, on its own card; its loss is its shard's sum over the global batch
size, so that the gradients summed over the ranks (one all-reduce after the
backward, with the step's loss and metric sums) are the JAX step's.
BatchNorm takes the global batch's statistics (``models/common.py``).
The weights start equal on every rank (``init_state`` broadcasts rank 0's)
and stay equal, since every rank applies the same summed gradients.

Width shards (``num_spatial_shards > 1``): the ranks of a data shard hold
strips of the same images' columns (``put_batch`` cuts them); the model
exchanges the halos it reads (``models/nlspn.py``), the loss divides each
strip's sums by the whole image's valid count, and the same one
all-reduce over every rank sums the gradients. The outputs of
``train_step`` and ``eval_step`` stay each rank's strips; ``whole``
gathers an output or a batch where the whole images are needed. With
``offset=True`` the deformable steps read a halo as wide as their reach
(the training window's, or the offsets' own in eval), or the whole width
where that reach passes the narrowest strip.

The initial weights are drawn from a generator seeded with ``cfg.seed``
(``utils/weights.init_weights_``), so a run's weights are a function of its
seed alone. ``init_backbone_pretrained`` puts torchvision's ImageNet ResNet
into the encoder stages and ``load_pretrained_params`` merges a
checkpoint's weights into the model, both as the JAX package's do.

Usage:
    eng = Engine(cfg, steps_per_epoch=len(loader))   # on the CUDA card
    eng.init_state()                                  # or init_state(state_dict)
    aux = eng.train_step(eng.put_train_batch(numpy_nhwc_batch))
    rows = eng.eval_step(eng.put_eval_batch(numpy_nhwc_batch))
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
from nlspn_eccv20_tpu_torch.metrics import (
    evaluate,
    evaluate_per_sample,
    metric_sums,
    metrics_from_sums,
)
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.parallel.halo import gather_tree
from nlspn_eccv20_tpu_torch.parallel.mesh import (
    all_reduce_sum_,
    check_batch,
    distributed,
    gather_to_main,
    make_mesh,
    replicate,
    shard_batch,
)
from nlspn_eccv20_tpu_torch.utils.optim import make_optimizer, set_lr
from nlspn_eccv20_tpu_torch.utils.torch_import import load_torchvision_resnet
from nlspn_eccv20_tpu_torch.utils.weights import init_weights_


def check_shards(cfg: Config) -> None:
    """Raise ``ValueError`` before any model is built or data is read
    where the ranks cannot run ``cfg``: width shards that do not divide the
    ranks (in the JAX package's ``make_mesh``'s words, "1 devices not
    divisible by num_spatial_shards=2" in one process), a
    ``num_data_shards`` other than 0 or the number of data shards, a
    training batch that does not divide over the data shards. One process
    accepts any ``num_data_shards``, as the JAX mesh does on one device."""
    mesh = make_mesh(cfg.num_data_shards, cfg.num_spatial_shards)
    if not cfg.test_only:
        check_batch(cfg.batch_size, mesh)


class Engine:
    """Owns the model, loss, optimizer and LR schedule, and runs the steps.

    ``device`` is the CUDA card unless the caller passes ``device="cpu"``
    (then every kernel runs its plain PyTorch version); in a process group,
    the rank's own card (the current device). A ``cfg`` the ranks cannot
    run is refused (``check_shards``)."""

    def __init__(self, cfg: Config, steps_per_epoch: int = 1, device=None):
        check_shards(cfg)
        self.cfg = cfg
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.model = init_weights_(get_model(cfg, device),
                                   torch.Generator().manual_seed(cfg.seed))
        self.device = self.model.aff_scale_const.device
        self.mesh = make_mesh(cfg.num_data_shards, cfg.num_spatial_shards, self.device)
        self.model.set_strips(self.mesh.strips)
        self.loss_fn = get_loss(cfg, self.mesh.strips)
        self.optimizer = None
        self.schedule = None
        self.step = 0

    @property
    def eval_batch_per_host(self) -> int:
        """The eval batch of this process: the data axis over the
        processes, as the JAX property gives it (``train.py:201-207``),
        which is 1 with one card a process (the reference evaluated at
        batch 1); the strips of one image share it."""
        return 1

    def whole(self, obj):
        """``obj`` (a batch, an output, or a tuple of them) with every
        strip made the whole image (``parallel/halo.gather_tree``); as it is
        without width shards. Every rank must call it."""
        if self.mesh.strips is None:
            return obj
        with torch.no_grad():
            return gather_tree(obj, self.mesh.strips)

    def checkpoint_state(self) -> Dict[str, Any]:
        """{net, optimizer, step, steps_per_epoch}, as
        ``utils/checkpoint.CheckpointManager.save`` takes it; the weights
        copied to the CPU."""
        return {"net": {k: v.detach().cpu()
                        for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "steps_per_epoch": self.steps_per_epoch}

    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None):
        """Load ``state_dict`` if given, make every rank's weights rank 0's
        (``replicate``), put the model in train mode and start a fresh
        optimizer at step 0. Returns the model."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        replicate(self.mesh, self.model)
        self.model.train()
        self.optimizer, self.schedule = make_optimizer(
            self.cfg, self.model.parameters(), self.steps_per_epoch)
        self.step = 0
        return self.model

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """NHWC numpy arrays (rgb, dep, gt) -> NCHW float32 tensors on the
        device: this rank's shard, which its loader read."""
        return shard_batch(self.mesh, batch)

    put_train_batch = put_batch
    put_eval_batch = put_batch

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """One optimizer step. Returns {loss, loss_val, metric, lr, output}:
        loss and loss_val divided by the global batch size, ``metric`` the
        global batch's (in a process group: every rank's, summed), ``lr``
        the rate this step used, ``output`` the model's output on this
        rank's shard (detached); with ``cfg.offset`` also ``off_max``, max
        |offset| over the global batch (for ``check_offset_telemetry``)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() first")
        gbatch = batch["rgb"].shape[0] * self.mesh.size
        lr = self.schedule(self.step)
        set_lr(self.optimizer, lr)
        self.optimizer.zero_grad(set_to_none=True)
        with cudnn_benchmark_mode():
            out = self.model(batch, need_inter=False)
            loss_sum, loss_val = self.loss_fn(batch, out)
            loss = loss_sum / gbatch
            loss.backward()
        out = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in out.items()}
        loss, loss_val = loss.detach(), loss_val.detach() / gbatch
        if distributed():
            loss, loss_val, metric = self._sum_over_ranks(batch, out, loss, loss_val)
        else:
            metric = evaluate(batch, out)
        self.optimizer.step()
        self.step += 1
        aux = {"loss": loss, "loss_val": loss_val, "metric": metric, "lr": lr,
               "output": out}
        if self.cfg.offset:
            aux["off_max"] = out["offset"].abs().max()
            if distributed():
                torch.distributed.all_reduce(aux["off_max"],
                                             op=torch.distributed.ReduceOp.MAX)
        return aux

    def _sum_over_ranks(self, batch, out, loss, loss_val):
        """Add every parameter's gradient, the loss, its terms and the
        metric sums over the ranks with one all-reduce; returns the global
        (loss, loss_val, metric). Every rank has gradients for the same
        parameters (``aff_scale_const`` has none unless TGASS, on all)."""
        sums, num_valid = metric_sums(batch, out)
        stats = torch.cat([loss.reshape(1), loss_val.float().reshape(-1),
                           sums.float(), num_valid.float().reshape(1)])
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        all_reduce_sum_(grads + [stats])
        n = loss_val.numel()
        metric = metrics_from_sums(stats[1 + n:9 + n], stats[9 + n])[None, :]
        return stats[0], stats[1:1 + n].reshape(loss_val.shape), metric

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor],
                  valid: Optional[int] = None) -> Dict[str, object]:
        """Eval-mode forward: per-image loss rows (B, terms + 1), metric
        rows (B, 8) and the output; ``valid`` keeps the first rows only
        (the rest pad the batch). The model goes back to train mode.

        In a process group every data shard's kept rows go to rank 0, which
        returns them in rank order (host tensors); the other ranks return
        their own. With one image a data shard and the loader's sharding
        (data shard d takes samples d, d + shards, ...) that order is the
        dataset's. ``output`` is the rank's own; under width shards the
        strips' rows are the whole images' (the sums added over the
        strips) and only each data shard's first strip sends them, and the
        output is the rank's strip (``whole`` gathers it)."""
        strips = self.mesh.strips
        self.model.eval()
        try:
            with cudnn_benchmark_mode():
                out = self.model(batch)
        finally:
            self.model.train()
        rows = {"loss_val": self.loss_fn.per_sample(batch, out)[:valid],
                "metric": evaluate_per_sample(batch, out, strips)[:valid]}
        if distributed():
            mine = {k: v.cpu() for k, v in rows.items()}
            if self.mesh.space_index == 0:
                every = gather_to_main(mine, self.mesh.data_group)
                rows = mine if every is None else {
                    k: torch.cat([r[k] for r in every]) for k in mine}
        return {**rows, "output": out}


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
