"""Channel and spatial pooling (port of ``ws_mgmap_tpu/ops/pooling.py``)."""
from __future__ import annotations

import numpy as np
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


def avg_pool2d_nhwc(x: torch.Tensor, kernel: int, stride: int
                    ) -> torch.Tensor:
    """``F.avg_pool2d`` (no padding) on an NHWC tensor; the result is
    NHWC. A view of a channels_last NCHW tensor costs no copy either
    way."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, stride)
    return y.permute(0, 2, 3, 1)


def interpolate_nearest_nhwc(x: torch.Tensor, out_hw: tuple[int, int]
                             ) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` on an NHWC tensor, with the JAX
    package's index rule: source index floor(dst * (in / out)), the
    product rounded to fp32 (100 -> 48 is not an integer scale, so the
    rounding decides some indices)."""
    h, w = x.shape[1:3]
    oh, ow = out_hw
    iy = np.floor(np.arange(oh, dtype=np.float32) * np.float32(h / oh))
    ix = np.floor(np.arange(ow, dtype=np.float32) * np.float32(w / ow))
    iy = torch.from_numpy(iy.astype(np.int64)).to(x.device)
    ix = torch.from_numpy(ix.astype(np.int64)).to(x.device)
    return x[:, iy[:, None], ix[None, :]]


def interpolate_area_nhwc(x: torch.Tensor, out_hw: tuple[int, int]
                          ) -> torch.Tensor:
    """``F.interpolate(mode='area')`` on an NHWC tensor: adaptive average
    pooling, bin i spanning [floor(i*in/out), ceil((i+1)*in/out)), which
    is also the JAX package's rule where the sizes do not divide."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out_hw)
    return y.permute(0, 2, 3, 1)
