"""The mapping chain in plain PyTorch: pinhole back-projection of the
depth, the scatter-max splat of the UNet's features onto the ego grid
(``scatter_reduce`` amax), the heading rotation, and the literal warp
chain of the reference's registration (paste the ego projection into a
global-size frame, translate by the GPS offset, max-fuse into the global
map, translate back, crop, rotate). Nothing is updated in place."""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS_INVALID = -1e16
DEPTH_SCALE = 10.0  # habitat depth in [0, 1] x 10 -> meters


def grid_size(cfg) -> float:
    cmax = cfg["global_map_size"] * cfg["resolution"] / 2.0
    return (cmax - (-cmax)) / cfg["global_map_size"]


def recip(v: float, dtype=torch.float32) -> float:
    """1 / v as an fp32 reciprocal of v rounded to ``dtype``."""
    vr = torch.tensor(v, dtype=dtype).to(torch.float32)
    return float(torch.tensor(1.0, dtype=torch.float32) / vr)


def subsample(src: int, dst: int, device) -> torch.Tensor:
    k = src / dst
    return (torch.arange(dst, dtype=torch.float32, device=device) * k).to(
        torch.int64)


def cell_ids(depth_m, ego_size: int, scale: float, out_hw, heading=None):
    """Each feature pixel's ego-grid cell, [B, Hf*Wf] int64, -1 where the
    depth is 0, the point lies outside the height band, or off the grid.
    ``heading`` [B] rotates the ground coordinates before binning."""
    b, h, w, _ = depth_m.shape
    dev = depth_m.device
    tan_half = torch.tan(torch.deg2rad(torch.tensor(45.0)))
    fx = ((h / 2.0) / tan_half).to(dev)
    fy = ((w / 2.0) / tan_half).to(dev)
    hf, wf = out_hw
    iy, ix = subsample(h, hf, dev), subsample(w, wf, dev)
    z = depth_m[..., 0][:, iy[:, None], ix[None, :]].float()
    xs = torch.arange(w, dtype=torch.float32, device=dev)[ix]
    ys = torch.arange(h, 0, -1, dtype=torch.float32, device=dev)[iy]
    xx = ((xs - h / 2.0) / fx)[None, None, :]
    yy = ((ys - w / 2.0) / fy)[None, :, None]
    y3d = yy * z
    valid = (z != 0) & (y3d > -1.5) & (y3d < 0.1)
    half = (ego_size - 1) / 2.0
    u = xx * z * recip(scale)
    v = -(z * recip(scale))
    if heading is not None:
        hd = heading.reshape(-1).float()
        c, s = torch.cos(hd)[:, None, None], torch.sin(hd)[:, None, None]
        u, v = c * u - s * v, s * u + c * v
    x_gp = torch.round(u + half).long()
    y_gp = torch.round(v + half).long()
    inside = (x_gp >= 0) & (x_gp < ego_size) & (y_gp >= 0) & (y_gp < ego_size)
    ids = torch.where(valid & inside, y_gp * ego_size + x_gp, -1)
    return ids.reshape(b, -1)


def splat(feats, ids, ego_size: int):
    """feats [B, P, C], ids [B, P] -> [B, E, E, C] fp32: the per-cell max,
    0 where no pixel landed or the max is <= -1e16."""
    b, p, c = feats.shape
    cells = ego_size * ego_size
    idx = torch.where(ids < 0, cells, ids)
    out = torch.full((b, cells + 1, c), float("-inf"), device=feats.device)
    out.scatter_reduce_(1, idx[:, :, None].expand(b, p, c), feats.float(),
                        "amax", include_self=False)
    out = out[:, :cells]
    out = torch.where(out <= EPS_INVALID, 0.0, out)
    return out.reshape(b, ego_size, ego_size, c)


def rotate(img, angle):
    """Bilinear rotation of an NHWC image about its centre by ``angle``
    [B] radians (``RotateTensor``: [[cos, sin, 0], [-sin, cos, 0]])."""
    a = angle.reshape(-1).float()
    c, s, z = torch.cos(a), torch.sin(a), torch.zeros_like(a)
    theta = torch.stack([torch.stack([c, s, z], -1),
                         torch.stack([-s, c, z], -1)], 1)
    n, h, w, ch = img.shape
    grid = F.affine_grid(theta, [n, ch, h, w], align_corners=False)
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def translate(img, tx, ty):
    """Bilinear translation of an NHWC image by (tx, ty) [B] in
    normalised coordinates (``affine_grid`` + ``grid_sample`` with
    align_corners False, zero outside), as a 4-tap stencil: a shift of
    (tx W / 2, ty H / 2) pixels."""
    b, h, w, _ = img.shape
    dev = img.device
    dx, dy = tx.float() * (w / 2.0), ty.float() * (h / 2.0)
    ix0, iy0 = torch.floor(dx), torch.floor(dy)
    fx = (dx - ix0)[:, None, None, None]
    fy = (dy - iy0)[:, None, None, None]
    rows = torch.arange(h, device=dev)[None, :] + iy0.long()[:, None]
    cols = torch.arange(w, device=dev)[None, :] + ix0.long()[:, None]
    bi = torch.arange(b, device=dev)[:, None, None]

    def tap(r, c):
        keep = (((r >= 0) & (r < h))[:, :, None]
                & ((c >= 0) & (c < w))[:, None, :])
        v = img[bi, r.clamp(0, h - 1)[:, :, None], c.clamp(0, w - 1)[:, None, :]]
        return torch.where(keep[..., None], v, torch.zeros((), device=dev))

    top = tap(rows, cols) * (1.0 - fx) + tap(rows, cols + 1) * fx
    bot = tap(rows + 1, cols) * (1.0 - fx) + tap(rows + 1, cols + 1) * fx
    return top * (1.0 - fy) + bot * fy


def register(cfg, global_map, ego_proj, gps, compass, masks):
    """The reference's registration (``rgb_mapping.py``): (ego_map, new
    global map)."""
    b = ego_proj.shape[0]
    g, e = cfg["global_map_size"], cfg["ego_map_size"]
    half = g // 2
    global_map = global_map.float() * masks.reshape(b, 1, 1, 1).float()
    cmax = g * cfg["resolution"] / 2.0
    inv = recip(grid_size(cfg))
    grid_x = torch.round((cmax - gps[:, 0].float()) * inv)
    grid_y = torch.round((gps[:, 1].float() + cmax) * inv)
    lo = half - e // 2
    view = ego_proj.new_zeros((b, g, g, ego_proj.shape[-1]))
    view[:, lo:lo + e, lo:lo + e] = ego_proj
    div = torch.tensor(float(half), device=grid_y.device)
    tx = -(grid_y - half) / div
    ty = -(grid_x - half) / div
    new_global = torch.maximum(global_map, translate(view, tx, ty))
    back = translate(new_global, -tx, -ty)
    return rotate(back[:, lo:lo + e, lo:lo + e], compass.reshape(b)), new_global


def mapping_step(cfg, global_map, proj_feat, depth, gps, compass, masks):
    """``RGBMapping.forward`` with the configuration's splat mode:
    rotate-in-splat bins each pixel at its heading-rotated ground
    coordinate; otherwise the axis-aligned splat is rotated bilinearly.
    Returns (ego_map, new global map)."""
    e = cfg["ego_map_size"]
    feats = proj_feat
    c = feats.shape[-1]
    d = cfg["map_depth"]
    if c != d:  # adaptive max pool over channels
        feats = torch.stack([feats[..., (i * c) // d:-(-((i + 1) * c) // d)]
                             .amax(-1) for i in range(d)], -1)
    b, hf, wf, _ = feats.shape
    heading = -compass.reshape(-1)
    depth_m = depth.float() * DEPTH_SCALE
    scale = grid_size(cfg)
    if cfg["rotate_in_splat"]:
        ids = cell_ids(depth_m, e, scale, (hf, wf), heading)
        proj = splat(feats.reshape(b, -1, d), ids, e)
    else:
        ids = cell_ids(depth_m, e, scale, (hf, wf))
        proj = rotate(splat(feats.reshape(b, -1, d), ids, e), heading)
    return register(cfg, global_map, proj, gps, compass, masks)
