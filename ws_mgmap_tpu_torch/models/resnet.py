"""ResNet trunks (port of ``ws_mgmap_tpu/models/resnet.py``): the
torchvision-style ResNet18 blocks of the UNet and the map decoder
(``BasicBlock``, ``ResLayer``, BatchNorm: fused in eval mode where the
gate allows, batch statistics in train mode) and habitat's DD-PPO
ResNet50 of the depth encoder (``GNBottleneck``, ``GNLayer``,
``DDPPOResNet``, GroupNorm, the same in either mode)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ws_mgmap_tpu_torch.models.layers import (fusable, fused_conv_bn,
                                              max_pool_3x3s2, tbn, tconv, tgn)


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


class GNBottleneck(nn.Module):
    """habitat ddppo Bottleneck: ``convs`` = Sequential(1x1, GN, ReLU, 3x3
    (stride), GN, ReLU, 1x1, GN), expansion 4, plus a ``downsample``
    (1x1, GN) where the shape changes; + identity, ReLU."""

    def __init__(self, in_c: int, planes: int, ngroups: int,
                 stride: int = 1):
        super().__init__()
        out_c = 4 * planes
        self.convs = nn.Sequential(
            tconv(in_c, planes, 1, 1, 0, bias=False), tgn(ngroups, planes),
            nn.ReLU(),
            tconv(planes, planes, 3, stride, 1, bias=False),
            tgn(ngroups, planes), nn.ReLU(),
            tconv(planes, out_c, 1, 1, 0, bias=False), tgn(ngroups, out_c))
        self.downsample = None
        if stride != 1 or in_c != out_c:
            self.downsample = nn.Sequential(
                tconv(in_c, out_c, 1, stride, 0, bias=False),
                tgn(ngroups, out_c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.convs(x) + identity)


class GNLayer(nn.Sequential):
    """``blocks`` bottlenecks ("0", "1", ...), the first with the stride."""

    def __init__(self, in_c: int, planes: int, ngroups: int, blocks: int,
                 stride: int = 1):
        super().__init__(GNBottleneck(in_c, planes, ngroups, stride),
                         *(GNBottleneck(4 * planes, planes, ngroups)
                           for _ in range(1, blocks)))


class DDPPOResNet(nn.Module):
    """habitat ddppo ``resnet50``: base planes 32, GroupNorm(16), layers
    [3, 4, 6, 3]; NCHW in, the 1/32-resolution map of 1024 channels out."""

    def __init__(self, in_c: int = 1, base_planes: int = 32,
                 ngroups: int = 16, layers=(3, 4, 6, 3)):
        super().__init__()
        bp = base_planes
        self.conv1 = tconv(in_c, bp, 7, 2, 3, bias=False)
        self.bn1 = tgn(ngroups, bp)
        self.layer1 = GNLayer(bp, bp, ngroups, layers[0], 1)
        self.layer2 = GNLayer(bp * 4, bp * 2, ngroups, layers[1], 2)
        self.layer3 = GNLayer(bp * 8, bp * 4, ngroups, layers[2], 2)
        self.layer4 = GNLayer(bp * 16, bp * 8, ngroups, layers[3], 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3s2(F.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
