"""Checkpoints with the reference's keep-last-1 rule, written with
``torch.save`` (counterpart of ``nlspn_eccv20_tpu/utils/checkpoint.py``).

An epoch's checkpoint is ``<save_dir>/ckpt/model_<epoch:05d>.pt`` in the
reference's layout::

    {"net": state_dict, "optimizer": optimizer.state_dict(), "step": int,
     "steps_per_epoch": int, "args": <the Config as JSON>}

with the reference's ``state_dict`` names, so that the reference's loaders
and the JAX package's ``utils/torch_import.load_nlspn_torch_checkpoint``
read it as it is. ``full=False`` (``--no_save_full``, non-final epochs)
keeps the weights only: ``net`` and ``steps_per_epoch``, which the resume
needs to refuse a changed loader length. A save writes a temporary file,
moves it into place, then deletes the older epochs; ``args.json`` sits
beside ``ckpt/``.

The JAX package's Orbax directories (``ckpt/<epoch>/``) cannot be read
here; ``utils/weights.from_jax_variables`` turns the JAX package's
variables into a port ``state_dict``.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import torch

from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.utils.torch_import import nlspn_state_dict

_NAME = re.compile(r"model_(\d+)\.pt$")


class CheckpointManager:
    WEIGHT_KEYS = ("net", "steps_per_epoch")

    def __init__(self, cfg: Config, save_dir: Optional[str] = None):
        self.cfg = cfg
        self.dir = os.path.abspath(save_dir or cfg.save_dir)
        self.ckpt_dir = os.path.join(self.dir, "ckpt")

    def path(self, epoch: int) -> str:
        return os.path.join(self.ckpt_dir, f"model_{epoch:05d}.pt")

    def epochs(self) -> List[int]:
        if not os.path.isdir(self.ckpt_dir):
            return []
        found = (_NAME.match(n) for n in os.listdir(self.ckpt_dir))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, state: Dict[str, Any], full: bool = True) -> str:
        """Save ``state`` ({net, optimizer, step, steps_per_epoch}) as
        ``epoch``'s checkpoint and delete the older ones; ``full=False``
        keeps the weight keys only. Returns the file's path."""
        if full:
            state = {**state, "args": self.cfg.to_json()}
        else:
            state = {k: state[k] for k in self.WEIGHT_KEYS}
        os.makedirs(self.ckpt_dir, exist_ok=True)
        out = self.path(epoch)
        fd, tmp = tempfile.mkstemp(dir=self.ckpt_dir, suffix=".pt.tmp")
        os.close(fd)
        try:
            torch.save(state, tmp)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.epochs():
            if old != epoch:
                os.remove(self.path(old))
        with open(os.path.join(self.dir, "args.json"), "w") as f:
            f.write(self.cfg.to_json())
        return out

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None) -> Dict[str, Any]:
        """The checkpoint of ``epoch`` (the latest by default), tensors on
        the CPU."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            if os.path.isdir(self.ckpt_dir) and any(
                    n.isdigit() for n in os.listdir(self.ckpt_dir)):
                raise ValueError(
                    f"{self.ckpt_dir} holds the JAX package's Orbax "
                    f"checkpoints, which the port cannot read; restore them "
                    f"with the JAX package and convert its variables with "
                    f"nlspn_eccv20_tpu_torch.utils.weights.from_jax_variables")
            raise FileNotFoundError(f"no checkpoint under {self.ckpt_dir}")
        return torch.load(self.path(epoch), map_location="cpu", weights_only=True)

    @staticmethod
    def load_config(save_dir: str) -> Config:
        with open(os.path.join(save_dir, "args.json")) as f:
            return Config.from_json(f.read()).finalize()


def load_weights(cfg: Config, src: str) -> Dict[str, torch.Tensor]:
    """The weights of ``src``: a reference or port checkpoint file
    (``.pt/.pth/.tar``), or a port experiment directory (its latest
    checkpoint)."""
    if os.path.isfile(src) and src.endswith((".pt", ".pth", ".tar")):
        return nlspn_state_dict(src)
    return CheckpointManager(cfg, src).restore()["net"]
