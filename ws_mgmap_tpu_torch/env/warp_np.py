"""Host-side (numpy) nearest-neighbor affine warps.

The GT semantic-map sensor performs its rotate/translate registration on the
CPU inside env workers (reference `habitat_extensions/sensors.py:390-405`
uses `F.grid_sample(mode='nearest')`). These numpy equivalents replicate the
torch ``align_corners=False`` grid semantics exactly (see ops/resample.py for
the on-device version).

The port's copy of ``ws_mgmap_tpu/env/warp_np.py``.
"""
from __future__ import annotations

import numpy as np


def affine_grid_np(theta: np.ndarray, h: int, w: int) -> np.ndarray:
    """[2,3] theta -> [h,w,2] sampling grid (x,y in [-1,1])."""
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    gx, gy = np.meshgrid(xs, ys)
    base = np.stack([gx, gy, np.ones_like(gx)], axis=-1)
    return np.einsum("kj,hwj->hwk", theta, base)


def grid_sample_nearest_np(img: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """img [h,w] (or [h,w,c]); grid [H,W,2]; zero padding; round-half-even."""
    h, w = img.shape[:2]
    ix = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    xi = np.rint(ix).astype(np.int64)
    yi = np.rint(iy).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi = np.clip(xi, 0, w - 1)
    yi = np.clip(yi, 0, h - 1)
    out = img[yi, xi]
    out = np.where(valid if img.ndim == 2 else valid[..., None], out, 0)
    return out


def rotation_theta_np(t: float) -> np.ndarray:
    """reference ``get_grid`` theta1 (`rgb_mapping.py:124-128`)."""
    return np.array([
        [np.cos(t), -np.sin(t), 0.0],
        [np.sin(t), np.cos(t), 0.0],
    ])


def translation_theta_np(x: float, y: float) -> np.ndarray:
    return np.array([[1.0, 0.0, x], [0.0, 1.0, y]])
