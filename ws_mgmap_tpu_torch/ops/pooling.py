"""Channel and spatial pooling (port of ``ws_mgmap_tpu/ops/pooling.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_max_pool_lastdim(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``F.adaptive_max_pool1d`` over the last dim (torch bins
    [floor(i*C/D), ceil((i+1)*C/D))). The identity when C == D, as at the
    default map depth of 64."""
    c = x.shape[-1]
    if c == out_size:
        return x
    outs = []
    for i in range(out_size):
        start = (i * c) // out_size
        end = -(-((i + 1) * c) // out_size)
        outs.append(x[..., start:end].amax(dim=-1))
    return torch.stack(outs, dim=-1)


def upsample_bilinear_x2_nchw(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``
    on an NCHW tensor (keeps a channels_last memory format)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def upsample_bilinear_x2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """The same upsample on an NHWC tensor; the result is NHWC."""
    y = upsample_bilinear_x2_nchw(x.permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1)
