"""MGMapNet + BasePolicy: the map-update step.

Port of the parts of ``ws_mgmap_tpu/models/policy.py`` that the map-update
step runs: ``MGMapConfig`` (the fields this step reads),
``MGMapNet.update_map`` and ``BasePolicy.update_map``. Module paths stay
``net.rgb_encoder.…`` so a state_dict carries over by key.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ws_mgmap_tpu_torch.models.unet import UNet
from ws_mgmap_tpu_torch.ops.mapping import MapperParams, rgb_mapping_step


@dataclasses.dataclass(frozen=True)
class MGMapConfig:
    """Static hyperparameters of the map-update step."""

    unet_width: float = 1.0
    map_depth: int = 64
    mapper: MapperParams = MapperParams()

    @classmethod
    def from_config(cls, model_cfg) -> "MGMapConfig":
        """From a yacs-like ``MODEL`` node, read by attribute."""
        m = model_cfg
        return cls(
            unet_width=getattr(m.RGB_ENCODER, "unet_width", 1.0),
            map_depth=m.RGBMAPPING.map_depth,
            mapper=MapperParams(
                resolution=m.RGBMAPPING.resolution,
                ego_size=m.RGBMAPPING.egocentric_map_size,
                global_size=m.RGBMAPPING.global_map_size,
                map_depth=m.RGBMAPPING.map_depth,
                rotate_in_splat=getattr(m.RGBMAPPING, "rotate_in_splat",
                                        False),
            ),
        )


class MGMapNet(nn.Module):
    def __init__(self, cfg: MGMapConfig):
        super().__init__()
        self.cfg = cfg
        self.rgb_encoder = UNet(width_mult=cfg.unet_width)

    def update_map(self, obs: dict[str, torch.Tensor], masks: torch.Tensor,
                   global_map: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Map-only step between decisions: UNet proj_feat -> projection ->
        registration. The global map is updated in place and returned."""
        _, proj_feat, _ = self.rgb_encoder(obs["rgb"])
        return rgb_mapping_step(global_map, proj_feat, obs["depth"],
                                obs["gps"], obs["compass"], masks,
                                self.cfg.mapper)


class BasePolicy(nn.Module):
    def __init__(self, cfg: MGMapConfig):
        super().__init__()
        self.cfg = cfg
        self.net = MGMapNet(cfg)

    def update_map(self, obs, masks, global_map):
        return self.net.update_map(obs, masks, global_map)
