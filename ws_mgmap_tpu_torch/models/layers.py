"""Building blocks with the reference's torch names.

Port of ``ws_mgmap_tpu/models/layers.py``. Modules take NCHW tensors,
normally in ``torch.channels_last`` memory format, so that the fused
kernel reads ``x.permute(0, 2, 3, 1)`` as a contiguous NHWC tensor. In
eval mode BatchNorm uses its running statistics and may be folded into
the fused conv; in train mode it normalizes with the batch's statistics
and updates the running ones by flax's rule (:class:`BatchNorm2d`).
"""
from __future__ import annotations

import contextlib
import weakref

import torch
import torch.nn as nn
import torch.nn.functional as F

from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.parallel import mesh


def tconv(in_c: int, out_c: int, kernel: int, stride: int = 1,
          padding: int = 0, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, kernel, stride, padding, bias=bias)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode follows flax's ``BatchNorm``
    (momentum 0.9 on the old value, torch's 0.1): the batch statistics
    are E[x] and E[x^2] - E[x]^2 (clipped at 0) over (N, H, W), and the
    running variance takes this biased variance, where torch's takes the
    unbiased one. The output is torch's train-mode batch norm. With
    ``track_running_stats`` off (:func:`bn_stats_frozen`) train mode
    leaves the running statistics as they are.

    With ``global_stats`` on (:func:`global_batch_stats`: the data-parallel
    update) train mode normalizes with the statistics of every rank's
    frames, as flax's BatchNorm does over a sharded batch: one
    differentiable SUM all-reduce of [sum x, sum x^2, count] per layer
    (its backward is a second one), then flax's normalization."""

    global_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.global_stats:
            return self._global_forward(x)
        if self.track_running_stats:
            with torch.no_grad():
                # at least fp32, as flax reduces
                xf = x.to(torch.promote_types(x.dtype, torch.float32))
                mean = xf.mean((0, 2, 3))
                var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_(min=0)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.num_features
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.new_full((1,), xf.numel() // c)
        sums = mesh.all_reduce_sum(torch.cat(
            [xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        mean = sums[:c] / sums[2 * c]
        var = (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp(min=0)
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        shape = (1, c, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def tbn(c: int) -> BatchNorm2d:
    """Flax-rule :class:`BatchNorm2d` (eps 1e-5, torch momentum 0.1)."""
    return BatchNorm2d(c, eps=1e-5)


@contextlib.contextmanager
def bn_stats_frozen(module: nn.Module):
    """Within the block, the train-mode :class:`BatchNorm2d` layers of
    ``module`` normalize with batch statistics but do not update their
    running ones: a recomputed forward (activation checkpointing) must not
    count its batch twice."""
    bns = [m for m in module.modules()
           if isinstance(m, BatchNorm2d) and m.track_running_stats]
    for m in bns:
        m.track_running_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.track_running_stats = True


@contextlib.contextmanager
def global_batch_stats(module: nn.Module):
    """Within the block, the train-mode :class:`BatchNorm2d` layers of
    ``module`` take their batch statistics over every rank of the process
    group (over this process's frames alone without one)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.global_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.global_stats = False


def tgn(groups: int, c: int) -> nn.GroupNorm:
    """``nn.GroupNorm(groups, c)`` (eps 1e-5)."""
    return nn.GroupNorm(groups, c, eps=1e-5)


def tdense(in_f: int, out_f: int, bias: bool = True) -> nn.Linear:
    return nn.Linear(in_f, out_f, bias=bias)


def tconv_transpose(in_c: int, out_c: int, kernel: int, stride: int,
                    padding: int, bias: bool = False) -> nn.ConvTranspose2d:
    """The JAX package's ``TConvTranspose``: its ``kernel_t`` leaf [kh, kw,
    I, O] is this module's weight [I, O, kh, kw] spatially flipped (the
    converter's ``kernel_t`` rule)."""
    return nn.ConvTranspose2d(in_c, out_c, kernel, stride, padding,
                              bias=bias)


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """``nn.MaxPool2d(kernel_size=3, stride=2, padding=1)``."""
    return F.max_pool2d(x, 3, 2, 1)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW view -> contiguous NHWC (free for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _source_key(t: torch.Tensor | None):
    """What identifies a source tensor's contents: its storage (a weak
    reference, alive only as long as the storage, so a freed block that
    the allocator hands out again never matches), where the tensor lies in
    it, its dtype and its version counter."""
    if t is None:
        return None
    return (weakref.ref(t.untyped_storage()), t.storage_offset(), t.dtype,
            tuple(t.shape), t._version)


def fused_operands(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype,
                   variant: str
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scale, bias, weight) of the fused kernel ``variant`` for this conv
    and BN: BN folded in fp32 from the statistics as stored (the engine's
    cast ones), the weight in ``dtype`` and in the layout of the variant's
    kernel (:func:`kconv.kernel_weight`). Built once and cached on
    ``conv``, keyed by :func:`_source_key` of every source tensor, so
    ``load_state_dict``, ``.to()`` and an in-place edit all rebuild it."""
    srcs = (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
            bn.running_var)
    key = (dtype, variant, bn.eps) + tuple(_source_key(t) for t in srcs)
    cached = getattr(conv, "_fused_cache", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            scale, bias = kconv.fold_bn(conv.bias, bn.weight, bn.bias,
                                        bn.running_mean, bn.running_var,
                                        bn.eps)
            w = kconv.kernel_weight(conv.weight.permute(2, 3, 1, 0).to(dtype),
                                    variant)
        cached = (key, (scale, bias, w))
        conv._fused_cache = cached
    return cached[1]


def fused_conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d,
                  relu: bool, residual: torch.Tensor | None = None,
                  x2: torch.Tensor | None = None) -> torch.Tensor:
    """conv -> frozen BN [-> + residual] [-> ReLU] through the fused 3x3
    kernel that :func:`kconv.conv_variant` picks, with the operands of
    :func:`fused_operands`: NCHW in, NCHW (channels_last) out."""
    variant = kconv.conv_variant(x.dtype, x.shape[1],
                                 0 if x2 is None else x2.shape[1],
                                 conv.out_channels)
    scale, bias, w = fused_operands(conv, bn, x.dtype, variant)
    y = kconv.KERNELS[variant](
        nhwc(x), w, scale, bias, relu=relu,
        residual=None if residual is None else nhwc(residual),
        x2=None if x2 is None else nhwc(x2))
    return y.permute(0, 3, 1, 2)


def fusable(x_shape_nchw, dtype: torch.dtype, device: torch.device,
            conv: nn.Conv2d, training: bool) -> bool:
    """The fused-conv gate for a conv of this module: eval only
    (train-mode BN normalizes with batch statistics and cannot be
    folded), padding 1, and :func:`fused_conv_active` on the NHWC shape
    (the JAX gate's sites; on the card fp32 as well as bf16)."""
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
