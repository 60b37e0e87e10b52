"""Seeded observation streams for the rollout traffic: agents walking
through a synthetic box room.

Each trajectory starts at a random pose, spins in place for the 24-step
look-around (15 degrees a step), then walks: 0.25 m forward steps while
the wall ahead is far enough, 15-degree turns otherwise and at random.
Depth is the room's z-distance seen through a 90-degree pinhole: the
nearest of the four walls, the floor and the ceiling, in habitat's
[0, 1] = [0, 10 m]. So the splat's cell ids spread over the ego grid as a
real scene spreads them: the floor near the agent, walls at their range.
RGB is random. GPS and compass are relative to the episode's start.
"""
from __future__ import annotations

import math

import numpy as np
import torch

TURN = math.radians(15.0)
FORWARD_M = 0.25
SPIN_STEPS = 24
MAX_DEPTH_M = 10.0


def trajectory(rng: np.random.Generator, steps: int, room_m, margin_m: float
               ) -> np.ndarray:
    """[steps, 3] poses (x, y, heading) in a room of ``room_m`` (width,
    depth) metres."""
    w, d = room_m
    x, y = rng.uniform(margin_m, w - margin_m), rng.uniform(margin_m,
                                                            d - margin_m)
    h = rng.uniform(-math.pi, math.pi)
    out = np.zeros((steps, 3))
    for k in range(steps):
        out[k] = (x, y, h)
        if k < SPIN_STEPS - 1:
            h += TURN
            continue
        nx, ny = x + FORWARD_M * math.cos(h), y + FORWARD_M * math.sin(h)
        ahead_ok = margin_m < nx < w - margin_m and margin_m < ny < d - margin_m
        if ahead_ok and rng.random() < 0.75:
            x, y = nx, ny
        else:
            h += TURN if rng.random() < 0.5 else -TURN
    return out


def depth_frames(poses: torch.Tensor, hw: int, room_m, camera_m: float,
                 ceiling_m: float) -> torch.Tensor:
    """[F, hw, hw, 1] habitat depth of ``poses`` [F, 3] on their device:
    per column the ray's distance to the walls, per row the floor or the
    ceiling where nearer, as z-depth along the optical axis."""
    dev = poses.device
    f = (hw / 2.0) / math.tan(math.radians(45.0))
    cols = (torch.arange(hw, device=dev, dtype=torch.float64) - hw / 2.0) / f
    rows = (torch.arange(hw, 0, -1, device=dev, dtype=torch.float64)
            - hw / 2.0) / f
    x, y, h = (poses[:, i:i + 1].double() for i in range(3))
    ang = h - torch.atan(cols)[None, :]          # [F, W], left of centre first
    cx, cy = torch.cos(ang), torch.sin(ang)
    big = torch.full_like(cx, 1e9)
    w, d = room_m
    tx = torch.where(cx > 1e-9, (w - x) / cx,
                     torch.where(cx < -1e-9, -x / cx, big))
    ty = torch.where(cy > 1e-9, (d - y) / cy,
                     torch.where(cy < -1e-9, -y / cy, big))
    z_wall = torch.minimum(tx, ty) / torch.sqrt(1.0 + cols[None, :] ** 2)
    r = rows[None, :, None]
    z_plane = torch.where(r < -1e-9, camera_m / -r,
                          torch.where(r > 1e-9, (ceiling_m - camera_m) / r,
                                      torch.full_like(r, 1e9)))
    z = torch.minimum(z_wall[:, None, :], z_plane)
    return (z.clamp(max=MAX_DEPTH_M) / MAX_DEPTH_M).float()[..., None]


class FramePool:
    """The frames of ``per_env`` trajectories of ``max_len`` steps for each
    of ``envs`` env slots, made once from the seed. ``frame(env, traj,
    k)`` is one observation dict (views into the pool, no copy)."""

    def __init__(self, seed: int, envs: int, per_env: int, max_len: int,
                 traffic: dict, rgb_hw: int, depth_hw: int, device):
        rng = np.random.default_rng([seed, 1])
        room = tuple(traffic["room_m"])
        poses = np.stack([
            trajectory(rng, max_len, room, traffic["margin_m"])
            for _ in range(envs * per_env)])              # [N, L, 3]
        self.shape = (envs, per_env, max_len)
        flat = torch.from_numpy(poses.reshape(-1, 3)).to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.depth = depth_frames(flat, depth_hw, room, traffic["camera_m"],
                                  traffic["ceiling_m"]).cpu().numpy()
        self.rgb = torch.randint(0, 256, (flat.shape[0], rgb_hw, rgb_hw, 3),
                                 generator=gen, device=device,
                                 dtype=torch.uint8).cpu().numpy()
        start = np.repeat(poses[:, :1], max_len, 1)
        rel = poses - start
        self.gps = rel[..., :2].reshape(-1, 2).astype(np.float32)
        heading = (rel[..., 2] + np.pi) % (2 * np.pi) - np.pi
        self.compass = heading.reshape(-1, 1).astype(np.float32)

    def index(self, env: int, traj: int, k: int) -> int:
        _, per_env, max_len = self.shape
        return (env * per_env + traj % per_env) * max_len + k

    def frame(self, idx: int, tokens: np.ndarray) -> dict:
        return {"instruction": tokens, "rgb": self.rgb[idx],
                "depth": self.depth[idx], "gps": self.gps[idx],
                "compass": self.compass[idx]}
