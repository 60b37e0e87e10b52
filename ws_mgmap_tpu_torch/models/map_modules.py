"""Map encoder, hallucination decoder and semantic classifier.

Port of ``ws_mgmap_tpu/models/map_modules.py`` with the reference's
torch keys. NCHW (channels_last) in and out. In eval mode the decoder's
four 3x3 ``ConvBNReLU`` sites go through the fused conv kernel where the
gate allows (bf16 on the card: ``csrc/conv3x3_wgmma.cu``), as in the JAX
package; the encoder's convs, the decoder's 6x6 BasicBlocks and the
classifier stay unfused there and here. In train mode every BatchNorm
uses batch statistics (flax's rule) and nothing is fused.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ws_mgmap_tpu_torch.models.layers import (ConvBNReLU, tbn, tconv,
                                              tconv_transpose)
from ws_mgmap_tpu_torch.models.unet import Layer0, Layer1
from ws_mgmap_tpu_torch.ops.pooling import upsample_bilinear_x2_nchw


class MapEncoder(nn.Module):
    """3-layer strided CNN ``cnn``: [B, 64, 100, 100] -> [B, 256, 24, 24]
    (kernels 8/5/3, strides 2/2/1)."""

    def __init__(self, in_channels: int = 64, out_channels: int = 256):
        super().__init__()
        self.cnn = nn.Sequential(
            tconv(in_channels, 64, 8, 2, 3), tbn(64), nn.ReLU(),
            tconv(64, 128, 5, 2, 1), tbn(128), nn.ReLU(),
            tconv(128, out_channels, 3, 1, 1), tbn(out_channels), nn.ReLU())

    @staticmethod
    def output_hw(map_size: int) -> int:
        d = map_size
        for k, s, p in ((8, 2, 3), (5, 2, 1), (3, 1, 1)):
            d = (d + 2 * p - k) // s + 1
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn(x)


class MapDecoder(nn.Module):
    """Mini-UNet over the encoded map: [B, 256, 24, 24] -> [B, 64, 24, 24]
    (a resnet18 stem, its layer1 and two upsamples). ``layer0`` and
    ``layer1`` are the UNet's stem modules (the JAX package's
    ``_DecLayer0`` / ``_DecLayer1``)."""

    def __init__(self, in_channels: int = 256):
        super().__init__()
        self.conv_original_size0 = ConvBNReLU(in_channels, 64, 3, 1)
        self.conv_original_size1 = ConvBNReLU(64, 64, 3, 1)
        self.layer0 = Layer0(in_channels, 64)
        self.layer1 = Layer1(64)
        self.layer1_1x1 = ConvBNReLU(64, 64, 1, 0)
        self.layer0_1x1 = ConvBNReLU(64, 64, 1, 0)
        self.conv_up0 = ConvBNReLU(64 + 64, 128, 3, 1)
        self.conv_original_size2 = ConvBNReLU(64 + 128, 64, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_original = self.conv_original_size1(self.conv_original_size0(x))
        layer0 = self.layer0(x)
        layer1 = self.layer1_1x1(self.layer1(layer0))
        y = upsample_bilinear_x2_nchw(layer1)
        # the skips go in as x2: the fused kernel reads them as their own
        # operand, the unfused path concatenates
        y = self.conv_up0(y, self.layer0_1x1(layer0))
        y = upsample_bilinear_x2_nchw(y)
        return self.conv_original_size2(y, x_original)


class MapClassifier(nn.Sequential):
    """``map_classfier``: ConvT(64 -> 32, k4 s2 p1) + BN + ReLU + Conv3 +
    BN + ReLU + Conv1 -> class logits at twice the decoder's side."""

    def __init__(self, num_classes: int = 27):
        super().__init__(
            tconv_transpose(64, 32, 4, 2, 1), tbn(32), nn.ReLU(),
            tconv(32, 32, 3, 1, 1, bias=False), tbn(32), nn.ReLU(),
            tconv(32, num_classes, 1, 1, 0, bias=True))
