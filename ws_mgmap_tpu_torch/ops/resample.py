"""Rotation about the image center (port of ``ws_mgmap_tpu/ops/resample.py``).

``F.affine_grid`` + ``F.grid_sample`` with ``align_corners=False`` and zero
padding, on channels-last images.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rotation_theta(angle: torch.Tensor, clockwise_xy: bool = False
                   ) -> torch.Tensor:
    """[N, 2, 3] fp32 affine matrices for a rotation about the center.

    ``clockwise_xy=False``: [[cos, -sin, 0], [sin, cos, 0]];
    ``clockwise_xy=True``:  [[cos, sin, 0], [-sin, cos, 0]] (the
    ``RotateTensor`` convention used by :func:`rotate_about_center`).
    """
    angle = angle.to(torch.float32).reshape(-1)
    cos_t, sin_t = torch.cos(angle), torch.sin(angle)
    zeros = torch.zeros_like(cos_t)
    if clockwise_xy:
        row0 = torch.stack([cos_t, sin_t, zeros], dim=-1)
        row1 = torch.stack([-sin_t, cos_t, zeros], dim=-1)
    else:
        row0 = torch.stack([cos_t, -sin_t, zeros], dim=-1)
        row1 = torch.stack([sin_t, cos_t, zeros], dim=-1)
    return torch.stack([row0, row1], dim=1)


def rotate_about_center(img: torch.Tensor, angle: torch.Tensor
                        ) -> torch.Tensor:
    """Bilinear rotation of an NHWC image by ``angle`` [N] radians.

    ``F.grid_sample`` needs the grid in the image's dtype, and a bf16 grid
    over 100 px is off by up to ~0.4 px. The JAX reference keeps the
    coordinate math in fp32, so a reduced-precision image is sampled in
    fp32 with an fp32 grid and cast back: the result differs from the JAX
    bf16 blend by about one bf16 ulp.
    """
    n, h, w, c = img.shape
    theta = rotation_theta(angle, clockwise_xy=True).to(img.device)
    grid = F.affine_grid(theta, [n, c, h, w], align_corners=False)
    src = img.permute(0, 3, 1, 2).to(torch.float32)
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).to(img.dtype).contiguous()
