"""Affine resampling (port of ``ws_mgmap_tpu/ops/resample.py``).

``F.affine_grid`` + ``F.grid_sample`` with zero padding, on channels-last
images; the translation stencil of ``translate_norm_fast`` in plain
tensor ops.
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


def translation_theta(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """[N, 2, 3] fp32 matrices [[1, 0, tx], [0, 1, ty]] of a translation
    in normalized coordinates (the reference's ``get_grid`` theta2)."""
    tx = torch.as_tensor(tx, dtype=torch.float32).reshape(-1)
    ty = torch.as_tensor(ty, dtype=torch.float32, device=tx.device
                         ).reshape(-1)
    ones, zeros = torch.ones_like(tx), torch.zeros_like(tx)
    row0 = torch.stack([ones, zeros, tx], dim=-1)
    row1 = torch.stack([zeros, ones, ty], dim=-1)
    return torch.stack([row0, row1], dim=1)


def affine_warp(img: torch.Tensor, theta: torch.Tensor,
                out_hw: tuple[int, int] | None = None,
                mode: str = "bilinear", align_corners: bool = False
                ) -> torch.Tensor:
    """``grid_sample(img, affine_grid(theta))`` on an NHWC image, zero
    padding; ``mode`` "bilinear" or "nearest" (round half to even).

    ``F.grid_sample`` needs the grid in the image's dtype, and a bf16 grid
    over 100 px is off by up to ~0.4 px. The JAX reference keeps the
    coordinate math in fp32, so a reduced-precision image is sampled in
    fp32 with an fp32 grid and cast back: the result differs from the JAX
    bf16 blend by about one bf16 ulp.
    """
    n, h, w, c = img.shape
    oh, ow = out_hw if out_hw is not None else (h, w)
    grid = F.affine_grid(theta.to(device=img.device, dtype=torch.float32),
                         [n, c, oh, ow], align_corners=align_corners)
    src = img.permute(0, 3, 1, 2).to(torch.float32)
    out = F.grid_sample(src, grid, mode=mode, padding_mode="zeros",
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1).to(img.dtype).contiguous()


def rotate_about_center(img: torch.Tensor, angle: torch.Tensor
                        ) -> torch.Tensor:
    """Bilinear rotation of an NHWC image by ``angle`` [N] radians (the
    reference's ``RotateTensor``)."""
    return affine_warp(img, rotation_theta(angle, clockwise_xy=True))


def translate_norm(img: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                   mode: str = "bilinear", align_corners: bool = False
                   ) -> torch.Tensor:
    """Translate an NHWC image by (tx, ty) [N] in normalized output
    coordinates: the general warp that :func:`translate_norm_fast`
    computes as a stencil."""
    return affine_warp(img, translation_theta(tx, ty), mode=mode,
                       align_corners=align_corners)


def translate_norm_fast(img: torch.Tensor, tx: torch.Tensor,
                        ty: torch.Tensor) -> torch.Tensor:
    """Bilinear translation as a 4-tap stencil.

    A pure translation under ``align_corners=False`` samples at
    ``x + tx * W / 2``: an integer shift plus one fractional weight per
    image. Each tap reads the image at the shifted rows and columns, zero
    outside, and the taps blend in the image's dtype as the JAX stencil
    does. Matches :func:`translate_norm` to fp32 rounding of the
    coordinate math.
    """
    b, h, w, _ = img.shape
    dev = img.device
    dx = torch.as_tensor(tx, dtype=torch.float32).to(dev).reshape(-1)
    dy = torch.as_tensor(ty, dtype=torch.float32).to(dev).reshape(-1)
    dx, dy = dx * (w / 2.0), dy * (h / 2.0)
    ix0, iy0 = torch.floor(dx), torch.floor(dy)
    fx = (dx - ix0)[:, None, None, None].to(img.dtype)
    fy = (dy - iy0)[:, None, None, None].to(img.dtype)
    rows = torch.arange(h, device=dev)[None, :] + iy0.to(torch.int64)[:, None]
    cols = torch.arange(w, device=dev)[None, :] + ix0.to(torch.int64)[:, None]
    bi = torch.arange(b, device=dev)[:, None, None]
    zero = torch.zeros((), dtype=img.dtype, device=dev)

    def tap(r, c):
        keep = (((r >= 0) & (r < h))[:, :, None]
                & ((c >= 0) & (c < w))[:, None, :])
        v = img[bi, r.clamp(0, h - 1)[:, :, None],
                c.clamp(0, w - 1)[:, None, :]]
        return torch.where(keep[..., None], v, zero)

    top = tap(rows, cols) * (1.0 - fx) + tap(rows, cols + 1) * fx
    bot = tap(rows + 1, cols) * (1.0 - fx) + tap(rows + 1, cols + 1) * fx
    return top * (1.0 - fy) + bot * fy
