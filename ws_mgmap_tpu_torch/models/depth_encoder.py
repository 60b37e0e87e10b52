"""DD-PPO ResNet50 depth encoder (frozen).

Port of ``ws_mgmap_tpu/models/depth_encoder.py``: habitat's
``ResNetEncoder`` (avg-pool /2 of the raw depth, GroupNorm ResNet50, 3x3
compression to 128 channels) plus 64 learned spatial-embedding channels.
Keys ``visual_encoder.backbone.*``, ``visual_encoder.compression.*`` and
``spatial_embeddings.weight``. NCHW inside; the trunk's output, which the
trainer caches as ``depth_features``, is NHWC at the boundary.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ws_mgmap_tpu_torch.models.layers import tconv, tgn
from ws_mgmap_tpu_torch.models.resnet import DDPPOResNet


class ResNetEncoder(nn.Module):
    """habitat ddppo ``ResNetEncoder`` over a depth observation."""

    def __init__(self, spatial_size: int = 128, in_channels: int = 1):
        super().__init__()
        self.backbone = DDPPOResNet(in_c=in_channels)
        s = spatial_size // 32
        self.output_channels = int(round(2048 / (s * s)))
        self.compression = nn.Sequential(
            tconv(1024, self.output_channels, 3, 1, 1, bias=False),
            tgn(1, self.output_channels), nn.ReLU())

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        """depth NCHW [B, 1, H, W] -> [B, 128, H/64, W/64]."""
        x = F.avg_pool2d(depth, 2)  # on the raw input, as habitat does
        return self.compression(self.backbone(x))


class VlnResnetDepthEncoder(nn.Module):
    """Depth trunk + spatial embeddings. ``spatial_hw`` is the trunk's
    output side (4 for 256^2 depth), which sizes the embedding table."""

    def __init__(self, spatial_hw: int = 4, spatial_size: int = 128,
                 embedding_dim: int = 64):
        super().__init__()
        self.visual_encoder = ResNetEncoder(spatial_size)
        self.spatial_embeddings = nn.Embedding(spatial_hw * spatial_hw,
                                               embedding_dim)

    def forward(self, depth: torch.Tensor | None = None,
                cached: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """depth NHWC [B, H, W, 1], or ``cached`` trunk output NHWC [B, h,
        w, 128] (which bypasses the trunk) -> (features NCHW [B, 128+64,
        h, w], trunk NHWC [B, h, w, 128])."""
        if cached is not None:
            x = cached.permute(0, 3, 1, 2)
        else:
            x = self.visual_encoder(depth.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last))
        b, _, h, w = x.shape
        # torch reshapes the [P, E] table to [E, h, w] row-major; it is
        # not a transpose
        spatial = self.spatial_embeddings.weight.reshape(-1, h, w)
        spatial = spatial[None].expand(b, -1, h, w)
        return torch.cat([x, spatial], 1), x.permute(0, 2, 3, 1)
