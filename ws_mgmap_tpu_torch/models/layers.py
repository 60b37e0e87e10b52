"""Building blocks with the reference's torch names (eval path only).

Port of ``ws_mgmap_tpu/models/layers.py``. Modules take NCHW tensors,
normally in ``torch.channels_last`` memory format, so that the fused
kernel reads ``x.permute(0, 2, 3, 1)`` as a contiguous NHWC tensor.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ws_mgmap_tpu_torch.ops.kernels import conv as kconv


def tconv(in_c: int, out_c: int, kernel: int, stride: int = 1,
          padding: int = 0, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, kernel, stride, padding, bias=bias)


def tbn(c: int) -> nn.BatchNorm2d:
    """``nn.BatchNorm2d`` (eps 1e-5); the port runs it in eval only."""
    return nn.BatchNorm2d(c, eps=1e-5)


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """``nn.MaxPool2d(kernel_size=3, stride=2, padding=1)``."""
    return F.max_pool2d(x, 3, 2, 1)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW view -> contiguous NHWC (free for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


def fused_conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d,
                  relu: bool, residual: torch.Tensor | None = None,
                  x2: torch.Tensor | None = None) -> torch.Tensor:
    """conv -> frozen BN [-> + residual] [-> ReLU] through the fused 3x3
    kernel: NCHW in, NCHW (channels_last) out."""
    scale, bias = kconv.fold_bn(conv.bias, bn.weight, bn.bias,
                                bn.running_mean, bn.running_var, bn.eps)
    w = conv.weight.permute(2, 3, 1, 0).contiguous().to(x.dtype)
    y = kconv.conv3x3_bn_relu(
        nhwc(x), w, scale, bias, relu=relu,
        residual=None if residual is None else nhwc(residual),
        x2=None if x2 is None else nhwc(x2))
    return y.permute(0, 3, 1, 2)


def fusable(x_shape_nchw, dtype: torch.dtype, device: torch.device,
            conv: nn.Conv2d, training: bool) -> bool:
    """The JAX gate for a conv of this module: eval only, padding 1, and
    :func:`fused_conv_active` on the NHWC shape."""
    b, c, h, w = x_shape_nchw
    return (not training and conv.padding == (1, 1)
            and kconv.fused_conv_active((b, h, w, c), dtype, device,
                                        conv.kernel_size[0], conv.stride[0],
                                        conv.groups))


class ConvBNReLU(nn.Sequential):
    """The reference's ``convrelu``: Conv2d ("0") -> BatchNorm2d ("1") ->
    ReLU. ``x2`` is an optional second input concatenated on channels (the
    UNet decoder's upsample + skip); the fused kernel reads it as its own
    operand, so the concat is never materialized."""

    def __init__(self, in_c: int, features: int, kernel: int, padding: int,
                 stride: int = 1):
        super().__init__(tconv(in_c, features, kernel, stride, padding,
                               bias=True), tbn(features))

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None
                ) -> torch.Tensor:
        conv, bn = self[0], self[1]
        full_c = x.shape[1] + (0 if x2 is None else x2.shape[1])
        shape = (x.shape[0], full_c, x.shape[2], x.shape[3])
        if fusable(shape, x.dtype, x.device, conv, self.training):
            return fused_conv_bn(x, conv, bn, relu=True, x2=x2)
        if x2 is not None:
            x = torch.cat([x, x2], dim=1)
        return F.relu(bn(conv(x)))
