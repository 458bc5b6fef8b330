"""Optimizer and LR schedule (counterpart of ``nlspn_eccv20_tpu/utils/optim.py``).

SGD (momentum) / Adam / RMSprop with coupled L2 weight decay, a
piecewise-constant epoch-decay factor from the ``--decay``/``--gamma`` DSL
and the epoch-1 linear warm-up ramp. The schedule is per step: the n-th
update (n = 0, 1, ...) uses ``schedule(n)``, as optax's count does; the
caller sets it before each ``optimizer.step()``.

The mapping onto ``torch.optim`` keeps optax's arithmetic: Adam and
RMSprop add eps outside the square root in both, RMSprop's decay is torch's
alpha (0.99), and ``optax.add_decayed_weights`` before the optimizer is
torch's ``weight_decay`` (the decay term added to the gradient).
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Returns step -> lr. Epochs are 1-indexed as in the reference."""
    decay, gamma = cfg.decay_schedule()
    steps_per_epoch = max(steps_per_epoch, 1)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch + 1
        factor = gamma[-1]
        for d, g in zip(decay, gamma):  # first boundary with epoch < d wins
            if epoch < d:
                factor = g
                break
        if cfg.warm_up and epoch <= 1:
            return cfg.lr * ((step + 1.0) / steps_per_epoch) * factor
        return cfg.lr * factor

    return schedule


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int) -> Tuple[torch.optim.Optimizer, Callable]:
    """(optimizer, schedule); the optimizer starts at ``schedule(0)``."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    lr, wd = schedule(0), cfg.weight_decay
    if cfg.optimizer == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                              weight_decay=wd)
    elif cfg.optimizer == "ADAM":
        opt = torch.optim.Adam(params, lr=lr, betas=tuple(cfg.betas),
                               eps=cfg.epsilon, weight_decay=wd)
    elif cfg.optimizer == "RMSprop":
        opt = torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=cfg.epsilon,
                                  weight_decay=wd)
    else:
        raise NotImplementedError(cfg.optimizer)
    return opt, schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
