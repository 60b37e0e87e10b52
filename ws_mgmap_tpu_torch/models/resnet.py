"""torchvision-style ResNet18 blocks (port of ``BasicBlock`` and
``ResLayer`` in ``ws_mgmap_tpu/models/resnet.py``), eval path only."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ws_mgmap_tpu_torch.models.layers import fused_conv_bn, fusable, tbn, tconv


class BasicBlock(nn.Module):
    """3x3 conv, BN, ReLU, 3x3 conv, BN, + identity, ReLU. Stride-1 convs
    go through the fused kernel where the gate allows, the second one with
    the residual add in its epilogue."""

    def __init__(self, in_c: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = tconv(in_c, planes, 3, stride, 1, bias=False)
        self.bn1 = tbn(planes)
        self.conv2 = tconv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = tbn(planes)
        self.downsample = None
        if stride != 1 or in_c != planes:
            self.downsample = nn.Sequential(
                tconv(in_c, planes, 1, stride, 0, bias=False), tbn(planes))

    def _fusable(self, x: torch.Tensor, conv: nn.Conv2d) -> bool:
        return fusable(x.shape, x.dtype, x.device, conv, self.training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        if self._fusable(x, self.conv1):
            out = fused_conv_bn(x, self.conv1, self.bn1, relu=True)
        else:
            out = F.relu(self.bn1(self.conv1(x)))
        if self._fusable(out, self.conv2):
            return fused_conv_bn(out, self.conv2, self.bn2, relu=True,
                                 residual=identity)
        return F.relu(self.bn2(self.conv2(out)) + identity)


class ResLayer(nn.Sequential):
    """A torchvision ``layerN``: two BasicBlocks ("0", "1")."""

    def __init__(self, in_c: int, planes: int, stride: int = 1):
        super().__init__(BasicBlock(in_c, planes, stride),
                         BasicBlock(planes, planes, 1))
