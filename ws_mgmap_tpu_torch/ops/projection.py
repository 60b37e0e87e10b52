"""Pinhole back-projection and the ground-plane scatter-max splat.

Port of ``ws_mgmap_tpu/ops/projection.py``. All images are channels-last.
The arithmetic copies the JAX package's as XLA compiles it, so that both
bin every pixel into the same cell: coordinate math in fp32, except where
JAX keeps a bf16 depth in bf16 (the forward distance ``v`` and, without
the heading rotation, the row coordinate), reproduced by computing in fp32
and rounding to bf16 at the same points; and a division by a constant is
a multiplication by its fp32 reciprocal, which is what XLA makes of it
under ``jit``.
"""
from __future__ import annotations

import torch

from ws_mgmap_tpu_torch.ops.kernels.splat import splat_max
from ws_mgmap_tpu_torch.ops.resample import rotate_about_center


def _subsample_indices(src: int, dst: int, device) -> torch.Tensor:
    """Reference index subsampling: floor(i * src / dst)."""
    k = src / dst
    return (torch.arange(dst, dtype=torch.float32, device=device) * k).to(
        torch.int64)


def recip(v: float, dtype: torch.dtype = torch.float32) -> float:
    """1 / v as XLA folds ``x / v`` under ``jit``: v rounded to ``dtype``,
    then its fp32 reciprocal (an exact fp32 value, so multiplying by it
    rounds the same on every device)."""
    vr = torch.tensor(v, dtype=dtype).to(torch.float32)
    return float(torch.tensor(1.0, dtype=torch.float32) / vr)


def spatial_locs(depth: torch.Tensor, ego_size: int, local_scale: float,
                 fov_deg: float = 90.0, out_hw: tuple[int, int] | None = None,
                 heading: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Back-project a depth map [B, H, W, 1] (meters) to ego-grid cells.

    ``out_hw`` index-subsamples the depth to the feature resolution first;
    ``heading`` [B] rotates the ground coordinates about the map center
    before binning (the rotate-in-splat path). Returns (x_gp, y_gp, valid),
    each [B, H', W'], integer cells (int32) and validity.
    """
    b, h, w, _ = depth.shape
    dev = depth.device
    z = depth[..., 0]
    cx, cy = h / 2.0, w / 2.0
    # focal lengths in fp32 as JAX computes them (tan of an fp32 angle),
    # evaluated on the host so every device bins with the same value
    # (128.0 for the 256^2, 90 degree sensor)
    tan_half = torch.tan(torch.deg2rad(torch.tensor(fov_deg / 2.0)))
    fx = ((h / 2.0) / tan_half).to(dev)
    fy = ((w / 2.0) / tan_half).to(dev)

    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, 0, -1, dtype=torch.float32, device=dev)
    if out_hw is not None and tuple(out_hw) != (h, w):
        oh, ow = out_hw
        iy = _subsample_indices(h, oh, dev)
        ix = _subsample_indices(w, ow, dev)
        z = z[:, iy[:, None], ix[None, :]]
        xs = xs[ix]
        ys = ys[iy]
    xx = ((xs - cx) / fx)[None, None, :]
    yy = ((ys - cy) / fy)[None, :, None]

    zf = z.to(torch.float32)
    x3d = xx * zf
    y3d = yy * zf
    valid = (z != 0) & (y3d > -1.5) & (y3d < 0.1)

    half = (ego_size - 1) / 2.0
    u = x3d * recip(local_scale)
    # JAX divides the depth in its own dtype by the scale rounded to it
    v = (-(zf * recip(local_scale, z.dtype))).to(z.dtype)
    if heading is not None:
        hd = heading.reshape(-1).to(torch.float32)
        c = torch.cos(hd)[:, None, None]
        s = torch.sin(hd)[:, None, None]
        vf = v.to(torch.float32)
        u, v = c * u - s * vf, s * u + c * vf
    x_gp = torch.round(u + half).to(torch.int32)
    y_gp = torch.round((v.to(torch.float32) + half).to(v.dtype)).to(
        torch.int32)
    return x_gp, y_gp, valid


def splat_to_ground(feats: torch.Tensor, x_gp: torch.Tensor,
                    y_gp: torch.Tensor, valid: torch.Tensor,
                    ego_size: int) -> torch.Tensor:
    """Scatter-max per-pixel features [B, Hf, Wf, C] onto the ego grid.

    Cell ids come from :func:`spatial_locs` (subsampled to the feature
    resolution if needed); invalid or off-grid pixels get id -1. Returns
    [B, E, E, C] in the feature dtype, 0 where no valid pixel landed.
    """
    b, hf, wf, c = feats.shape
    hd, wd = x_gp.shape[1:]
    if (hd, wd) != (hf, wf):
        iy = _subsample_indices(hd, hf, feats.device)
        ix = _subsample_indices(wd, wf, feats.device)
        x_gp = x_gp[:, iy[:, None], ix[None, :]]
        y_gp = y_gp[:, iy[:, None], ix[None, :]]
        valid = valid[:, iy[:, None], ix[None, :]]
    in_bounds = (x_gp >= 0) & (x_gp < ego_size) & (y_gp >= 0) & (
        y_gp < ego_size)
    ids = torch.where(valid & in_bounds, y_gp * ego_size + x_gp, -1).to(
        torch.int32)
    out = splat_max(feats.reshape(b, -1, c).contiguous(),
                    ids.reshape(b, -1).contiguous(), ego_size)
    return out.to(feats.dtype)


def project_egocentric(feats: torch.Tensor, depth_m: torch.Tensor,
                       heading: torch.Tensor, ego_size: int = 100,
                       local_scale: float = 0.12,
                       rotate_coords: bool = False) -> torch.Tensor:
    """Pinhole -> splat -> rotate to heading (``Projection.forward``).

    ``rotate_coords=True`` rotates each pixel's ground coordinate before
    binning, so the splat writes the heading-aligned grid directly (the
    production rollout mode); ``False`` splats axis-aligned and then warps
    the grid bilinearly (the fp32 parity mode).
    """
    out_hw = tuple(feats.shape[1:3])
    if rotate_coords:
        x_gp, y_gp, valid = spatial_locs(depth_m, ego_size, local_scale,
                                         out_hw=out_hw, heading=heading)
        return splat_to_ground(feats, x_gp, y_gp, valid, ego_size)
    x_gp, y_gp, valid = spatial_locs(depth_m, ego_size, local_scale,
                                     out_hw=out_hw)
    grid = splat_to_ground(feats, x_gp, y_gp, valid, ego_size)
    return rotate_about_center(grid, heading)
