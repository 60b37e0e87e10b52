"""Egocentric-to-global map registration: the per-step hot path.

Port of ``ws_mgmap_tpu/ops/mapping.py``. The persistent global map
[B, G, G, C] (channels-last) is a tensor on the device that
:func:`register_and_retrieve` updates **in place**: the JAX package
donates the same buffer to its step, so no caller keeps the old map.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ws_mgmap_tpu_torch.ops.pooling import adaptive_max_pool_lastdim
from ws_mgmap_tpu_torch.ops.projection import project_egocentric, recip
from ws_mgmap_tpu_torch.ops.resample import (rotate_about_center,
                                             translate_norm_fast)
from ws_mgmap_tpu_torch.utils.device import resolve_device


class MapperParams(NamedTuple):
    """Static geometry of the mapper (reference ``config/default.py``)."""

    resolution: float = 0.12
    ego_size: int = 100
    global_size: int = 240
    map_depth: int = 64
    depth_scale: float = 10.0  # habitat depth in [0,1] x10 -> meters
    # ground splat: "auto" or "pallas" (the JAX names) both mean the splat
    # kernel's wrapper, which launches csrc/splat.cu on the card and runs
    # its plain twin on the CPU
    splat_backend: str = "auto"
    # rotate the splat coordinates instead of bilinearly warping the
    # splatted grid: the production rollout mode, off in fp32 parity mode
    rotate_in_splat: bool = False

    @property
    def coordinate_min(self) -> float:
        return -self.global_size * self.resolution / 2.0

    @property
    def coordinate_max(self) -> float:
        return self.global_size * self.resolution / 2.0

    @property
    def grid_size(self) -> float:
        return (self.coordinate_max - self.coordinate_min) / self.global_size


def init_global_map(num_envs: int, p: MapperParams,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """A fresh zero global map on ``device`` (the card unless "cpu")."""
    return torch.zeros((num_envs, p.global_size, p.global_size, p.map_depth),
                       dtype=dtype, device=resolve_device(device))


def gps_to_grid(gps: torch.Tensor, p: MapperParams
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``to_grid.get_grid_coords``: rounded (row, col) grid coordinates."""
    inv = recip(p.grid_size)
    grid_x = torch.round((p.coordinate_max - gps[:, 0].float()) * inv)
    grid_y = torch.round((gps[:, 1].float() - p.coordinate_min) * inv)
    return grid_x, grid_y


def _shift2d(img: torch.Tensor, sr: torch.Tensor, sc: torch.Tensor
             ) -> torch.Tensor:
    """out[b, k, l] = img[b, k - sr[b], l - sc[b]], zero outside."""
    b, e = img.shape[:2]
    ks = torch.arange(e, device=img.device)
    ri = ks[None, :] - sr[:, None]
    ci = ks[None, :] - sc[:, None]
    keep = (((ri >= 0) & (ri < e))[:, :, None]
            & ((ci >= 0) & (ci < e))[:, None, :])
    bi = torch.arange(b, device=img.device)[:, None, None]
    out = img[bi, ri.clamp(0, e - 1)[:, :, None], ci.clamp(0, e - 1)[:, None, :]]
    return torch.where(keep[..., None], out, torch.zeros((), dtype=img.dtype,
                                                         device=img.device))


def register_and_retrieve(global_map: torch.Tensor, ego_proj: torch.Tensor,
                          gps: torch.Tensor, compass: torch.Tensor,
                          masks: torch.Tensor, p: MapperParams
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-fuse one ego projection into the global map and read it back.

    The reference's translate warps move by rounded grid coordinates, so
    the warp pair is an integer window update: clamp the E x E window into
    the map, counter-shift the ego patch by what the clamp moved (ego
    content past the map edge is dropped), max-fuse, and read the fused
    window back at the unclamped origin (zero past the edge), then rotate
    by the compass.

    global_map [B, G, G, C] is updated in place and returned; ego_proj
    [B, E, E, C]; gps [B, 2]; compass and masks [B, 1] or [B] (masks 0
    clears the map at an episode start). Returns (ego_map, global_map).
    """
    b = ego_proj.shape[0]
    g, e = p.global_size, p.ego_size
    global_map.mul_(masks.reshape(b, 1, 1, 1).to(global_map.dtype))

    grid_x, grid_y = gps_to_grid(gps, p)
    r0 = grid_x.to(torch.int64) - e // 2
    c0 = grid_y.to(torch.int64) - e // 2
    rc = r0.clamp(0, g - e)
    cc = c0.clamp(0, g - e)
    dr, dc = r0 - rc, c0 - cc

    ks = torch.arange(e, device=global_map.device)
    bi = torch.arange(b, device=global_map.device)[:, None, None]
    rows = (rc[:, None] + ks)[:, :, None]
    cols = (cc[:, None] + ks)[:, None, :]
    window = global_map[bi, rows, cols]
    fused = torch.maximum(window, _shift2d(ego_proj.to(global_map.dtype),
                                           dr, dc))
    global_map[bi, rows, cols] = fused
    crop = _shift2d(fused, -dr, -dc)
    ego_map = rotate_about_center(crop, compass.reshape(b))
    return ego_map, global_map


def register_and_retrieve_reference(
        global_map: torch.Tensor, ego_proj: torch.Tensor, gps: torch.Tensor,
        compass: torch.Tensor, masks: torch.Tensor, p: MapperParams
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The literal warp chain of the reference (`rgb_mapping.py:32-72`):
    paste the ego projection into the center of a G x G frame, translate
    it by the GPS grid offset, max-fuse it into the global map, translate
    back, crop the center E x E and rotate by the compass. The oracle for
    :func:`register_and_retrieve`; the same arguments, but ``global_map``
    is left as it was and the new map is returned."""
    b = ego_proj.shape[0]
    g, e = p.global_size, p.ego_size
    half = g // 2
    global_map = global_map * masks.reshape(b, 1, 1, 1).to(global_map.dtype)
    grid_x, grid_y = gps_to_grid(gps, p)

    lo = half - e // 2
    agent_view = ego_proj.new_zeros((b, g, g, ego_proj.shape[-1]))
    agent_view[:, lo:lo + e, lo:lo + e] = ego_proj
    # true division on every device, as eager JAX divides: PyTorch's CUDA
    # kernel divides by a Python scalar as a multiply by its fp32
    # reciprocal, and then tx * G / 2 misses the whole shift (and blends
    # in a neighbour) at 284 of the 481 shifts in [-240, 240], not at 8
    div = torch.tensor(float(half), device=grid_y.device)
    tx = -(grid_y - half) / div
    ty = -(grid_x - half) / div
    translated = translate_norm_fast(agent_view, tx, ty)
    new_global = torch.maximum(global_map, translated)

    back = translate_norm_fast(new_global, -tx, -ty)
    crop = back[:, lo:lo + e, lo:lo + e]
    return rotate_about_center(crop, compass.reshape(b)), new_global


def rgb_mapping_step(global_map: torch.Tensor, rgb_proj_feat: torch.Tensor,
                     depth: torch.Tensor, gps: torch.Tensor,
                     compass: torch.Tensor, masks: torch.Tensor,
                     p: MapperParams) -> tuple[torch.Tensor, torch.Tensor]:
    """``RGBMapping.forward``: pool the UNet feature [B, 224, 224, C] to
    ``map_depth`` channels, project it with the depth [B, 256, 256, 1] in
    [0, 1], and register it. Returns (ego_map, global_map), the global map
    updated in place."""
    if p.splat_backend not in ("auto", "pallas"):
        raise ValueError(f"splat_backend {p.splat_backend!r}: the port has "
                         "one splat, the kernel wrapper ('auto')")
    feats = adaptive_max_pool_lastdim(rgb_proj_feat, p.map_depth)
    ego_proj = project_egocentric(
        feats, depth * p.depth_scale, -compass.reshape(-1),
        ego_size=p.ego_size, local_scale=p.grid_size,
        rotate_coords=p.rotate_in_splat)
    return register_and_retrieve(global_map, ego_proj, gps, compass, masks, p)
