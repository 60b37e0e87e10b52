"""ResNet18-backbone UNet RGB segmenter, frozen in the policy.

Port of ``ws_mgmap_tpu/models/unet.py``. Submodule names reproduce the
reference's torch keys (``base_model.layer1.1.0.conv1.weight``, ...).
Input and outputs are NHWC; inside, tensors are NCHW in channels_last
memory format.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ws_mgmap_tpu_torch.models.layers import (ConvBNReLU, max_pool_3x3s2, tbn,
                                              tconv)
from ws_mgmap_tpu_torch.models.resnet import ResLayer
from ws_mgmap_tpu_torch.ops.pooling import upsample_bilinear_x2_nchw


class _Layer0(nn.Sequential):
    """Sequential(conv1 7x7 s2, bn1, relu) == resnet children[:3]."""

    def __init__(self, in_c: int, out_c: int = 64):
        super().__init__(tconv(in_c, out_c, 7, 2, 3, bias=False), tbn(out_c),
                         nn.ReLU())


class _Layer1(nn.Module):
    """Sequential(maxpool, resnet.layer1) == resnet children[3:5]; the
    parameter-free max pool is index "0", so layer1's keys sit under "1"."""

    def __init__(self, c: int = 64):
        super().__init__()
        self.add_module("1", ResLayer(c, c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, "1")(max_pool_3x3s2(x))


class ResNetUNet(nn.Module):
    """3 -> 27 classes at 224x224. ``width_mult`` scales every internal
    channel count (1.0 is the reference architecture)."""

    def __init__(self, n_channel_in: int = 3, n_class_out: int = 27,
                 width_mult: float = 1.0):
        super().__init__()
        c64, c128, c256, c512 = (max(8, int(c * width_mult))
                                 for c in (64, 128, 256, 512))
        self.conv_original_size0 = ConvBNReLU(n_channel_in, c64, 3, 1)
        self.conv_original_size1 = ConvBNReLU(c64, c64, 3, 1)
        self.layer0 = _Layer0(n_channel_in, c64)
        self.layer1 = _Layer1(c64)
        self.layer2 = ResLayer(c64, c128, 2)
        self.layer3 = ResLayer(c128, c256, 2)
        self.layer4 = ResLayer(c256, c512, 2)
        self.layer4_1x1 = ConvBNReLU(c512, c512, 1, 0)
        self.layer3_1x1 = ConvBNReLU(c256, c256, 1, 0)
        self.conv_up3 = ConvBNReLU(c256 + c512, c512, 3, 1)
        self.layer2_1x1 = ConvBNReLU(c128, c128, 1, 0)
        self.conv_up2 = ConvBNReLU(c128 + c512, c256, 3, 1)
        self.layer1_1x1 = ConvBNReLU(c64, c64, 1, 0)
        self.conv_up1 = ConvBNReLU(c64 + c256, c256, 3, 1)
        self.layer0_1x1 = ConvBNReLU(c64, c64, 1, 0)
        self.conv_up0 = ConvBNReLU(c64 + c256, c128, 3, 1)
        self.conv_original_size2 = ConvBNReLU(c64 + c128, c64, 3, 1)
        self.conv_last = tconv(c64, n_class_out, 1, 1, 0, bias=True)

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, H, W, 3] -> (bottleneck [B, H/32, W/32, 512],
        proj_feat [B, H, W, 64], seg [B, H, W, 27]) at width 1, NHWC."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x_original = self.conv_original_size0(x)
        x_original = self.conv_original_size1(x_original)

        layer0 = self.layer0(x)
        layer1 = self.layer1(layer0)
        layer2 = self.layer2(layer1)
        layer3 = self.layer3(layer2)
        layer4 = self.layer4(layer3)
        layer4 = self.layer4_1x1(layer4)
        bottleneck = layer4

        # decoder: the upsample + skip concats go in as x2
        y = upsample_bilinear_x2_nchw(layer4)
        y = self.conv_up3(y, self.layer3_1x1(layer3))
        y = upsample_bilinear_x2_nchw(y)
        y = self.conv_up2(y, self.layer2_1x1(layer2))
        y = upsample_bilinear_x2_nchw(y)
        y = self.conv_up1(y, self.layer1_1x1(layer1))
        y = upsample_bilinear_x2_nchw(y)
        y = self.conv_up0(y, self.layer0_1x1(layer0))
        y = upsample_bilinear_x2_nchw(y)
        proj_feat = self.conv_original_size2(y, x_original)
        seg = self.conv_last(proj_feat)

        def out(t):
            return t.permute(0, 2, 3, 1)

        return out(bottleneck), out(proj_feat), out(seg)


class UNet(nn.Module):
    """The reference's ``UNet`` wrapper: the segmenter is ``base_model``."""

    def __init__(self, width_mult: float = 1.0):
        super().__init__()
        self.base_model = ResNetUNet(width_mult=width_mult)

    def forward(self, rgb: torch.Tensor):
        return self.base_model(rgb)
