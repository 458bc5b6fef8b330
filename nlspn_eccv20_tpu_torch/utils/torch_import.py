"""Reference NLSPN checkpoints and torchvision ResNet weights into the port
(counterpart of ``nlspn_eccv20_tpu/utils/torch_import.py``).

The port's parameters carry the reference's ``state_dict`` names, so both
loaders are near-identity: a reference checkpoint's ``net`` loads as it is
once DistributedDataParallel's ``module.`` prefix is stripped, and
torchvision's ``layer1..layer3`` are the port's ``conv2..conv4``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from nlspn_eccv20_tpu_torch.models.resnet import STAGE_BLOCKS

# the reference model's frozen gather weights; the port's propagation has
# no weights, so they have no counterpart (the JAX import skips them too)
_REFERENCE_ONLY = ("w", "b", "w_conf")


def nlspn_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The weights of a checkpoint file: a reference training checkpoint
    ``{net: state_dict, args: Namespace}``, a port checkpoint, or a bare
    ``state_dict``, with ``module.`` stripped."""
    # A reference checkpoint pickles an argparse Namespace under "args",
    # which torch.load unpickles only with weights_only=False; so load only
    # files you trust. The port's own checkpoints are read with
    # weights_only=True (utils/checkpoint.py).
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["net"] if isinstance(ckpt, dict) and "net" in ckpt else ckpt
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    return {k: v for k, v in sd.items() if k not in _REFERENCE_ONLY}


def load_nlspn_torch_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a reference (or port) checkpoint file into ``model``; every
    name must match (``train.load_pretrained_params`` is the lenient
    form)."""
    model.load_state_dict(nlspn_state_dict(path))
    return model


def load_torchvision_resnet(path: str, network: str) -> Dict[str, torch.Tensor]:
    """A torchvision resnet18/34 ``.pth`` -> the port's ``conv2..conv4``
    entries (torchvision's ``layer1..layer3``, block for block)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for stage, layer, nb in zip(("conv2", "conv3", "conv4"),
                                ("layer1", "layer2", "layer3"),
                                STAGE_BLOCKS[network]):
        for b in range(nb):
            pre = f"{layer}.{b}."
            block = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
            if not block:
                raise KeyError(f"{path} has no {pre}* tensors for {network}")
            out.update({f"{stage}.{b}.{k}": v for k, v in block.items()})
    return out
