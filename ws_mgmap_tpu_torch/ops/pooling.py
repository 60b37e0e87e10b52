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


def adaptive_avg_pool_lastdim(x: torch.Tensor, out_size: int
                              ) -> torch.Tensor:
    """``nn.AdaptiveAvgPool1d`` over the last dim, with the same bins."""
    if out_size == 1:
        return x.mean(dim=-1, keepdim=True)
    c = x.shape[-1]
    outs = []
    for i in range(out_size):
        start = (i * c) // out_size
        end = -(-((i + 1) * c) // out_size)
        outs.append(x[..., start:end].mean(dim=-1))
    return torch.stack(outs, dim=-1)


def upsample_x2_taps(h: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (i0, i1, w) of align_corners=True bilinear x2 along an axis
    of ``h``: out[o] = (1 - w[o]) * x[i0[o]] + w[o] * x[i1[o]], the
    weights computed in fp32 as the JAX package computes them."""
    oh = 2 * h
    ys = np.arange(oh, dtype=np.float32) * np.float32((h - 1) / (oh - 1))
    y0 = np.floor(ys).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    return y0, y1, (ys - y0).astype(np.float32)


def upsample_bilinear_x2_nhwc_blend(x: torch.Tensor) -> torch.Tensor:
    """The align_corners=True bilinear x2 upsample of an NHWC tensor as a
    gather blend: two index selects and a 2-tap weighted sum per axis,
    over :func:`upsample_x2_taps`' static indices, blended in the
    tensor's dtype."""
    _, h, w, _ = x.shape
    i0h, i1h, wh = upsample_x2_taps(h)
    i0w, i1w, ww = upsample_x2_taps(w)

    def blend(t, dim, i0, i1, wt, shape):
        wt = torch.from_numpy(wt).to(device=t.device, dtype=t.dtype
                                     ).reshape(shape)
        i0 = torch.from_numpy(i0).to(t.device)
        i1 = torch.from_numpy(i1).to(t.device)
        return (t.index_select(dim, i0) * (1 - wt)
                + t.index_select(dim, i1) * wt)

    y = blend(x, 1, i0h, i1h, wh, (1, -1, 1, 1))
    return blend(y, 2, i0w, i1w, ww, (1, 1, -1, 1))


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
