"""ResNet-18/34 encoder stages (BasicBlock), with torchvision child names.

Counterpart of ``nlspn_eccv20_tpu/models/resnet.py``. NLSPN uses
torchvision's ``layer1..layer3`` and stores them as ``conv2..conv4``; the
child names here (``0.conv1``, ``0.bn1``, ``0.downsample.0`` ...) are
torchvision's, so a torchvision or reference ``state_dict`` loads as it is.
A block computes in its input's dtype, the residual add included
(``models/common.py`` says how the blocks cast).
"""

from __future__ import annotations

from torch import nn

from nlspn_eccv20_tpu_torch.models.common import BatchNorm, Conv2d


def _resnet_conv(ch_in: int, ch_out: int, kernel: int, stride: int) -> nn.Conv2d:
    conv = Conv2d(ch_in, ch_out, kernel, stride, kernel // 2, bias=False)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
    conv.fan_out_init = True     # for utils.weights.init_weights_
    return conv


class BasicBlock(nn.Module):
    def __init__(self, ch_in: int, ch_out: int, stride: int = 1):
        super().__init__()
        self.conv1 = _resnet_conv(ch_in, ch_out, 3, stride)
        self.bn1 = BatchNorm(ch_out)
        self.relu = nn.ReLU()
        self.conv2 = _resnet_conv(ch_out, ch_out, 3, 1)
        self.bn2 = BatchNorm(ch_out)
        self.downsample = None
        if stride != 1 or ch_in != ch_out:
            self.downsample = nn.Sequential(
                _resnet_conv(ch_in, ch_out, 1, stride), BatchNorm(ch_out))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class ResNetStage(nn.Sequential):
    """One torchvision ``layerN``: a stack of BasicBlocks."""

    def __init__(self, ch_in: int, ch_out: int, num_blocks: int, stride: int = 1):
        super().__init__(*[
            BasicBlock(ch_in if i == 0 else ch_out, ch_out,
                       stride if i == 0 else 1)
            for i in range(num_blocks)])


# torchvision resnet18 layers 1-3: (2, 2, 2) blocks; resnet34: (3, 4, 6).
STAGE_BLOCKS = {"resnet18": (2, 2, 2), "resnet34": (3, 4, 6)}


def make_encoder_stages(network: str):
    """Returns (layer1, layer2, layer3): 64->64 s1, ->128 s2, ->256 s2."""
    if network not in STAGE_BLOCKS:
        raise NotImplementedError(f"network {network}")
    n1, n2, n3 = STAGE_BLOCKS[network]
    return (ResNetStage(64, 64, n1, 1), ResNetStage(64, 128, n2, 2),
            ResNetStage(128, 256, n3, 2))
