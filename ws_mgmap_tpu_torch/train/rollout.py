"""Device-side rollout engine: the map-update step of collection and eval.

Port of the serving part of ``ws_mgmap_tpu/train/rollout.py``
(``RolloutEngine.__init__``, ``reset_state``, ``keep``, ``batch_obs`` and
``update_map``). The persistent global map stays on the device and each
step updates it in place.
"""
from __future__ import annotations

import copy
from typing import Any, Sequence

import numpy as np
import torch

from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.ops.mapping import init_global_map
from ws_mgmap_tpu_torch.utils.device import resolve_device


class RolloutEngine:
    """compute_dtype: None = fp32 (parity with the reference's eval);
    ``torch.bfloat16`` = the reduced-precision rollout mode for the frozen
    trunks. Every floating weight and buffer, BN running statistics
    included, is cast before BN is folded into the fused convs. On the
    card, fp32 parity also needs ``torch.backends.cudnn.allow_tf32 =
    False``: by default PyTorch lets cuDNN run fp32 convolutions in TF32.

    The engine keeps its own copy of ``policy`` on ``device`` (the card
    unless ``device="cpu"``), in eval mode.
    """

    def __init__(self, policy: BasePolicy, num_envs: int,
                 instruction_len: int = 200,
                 compute_dtype: torch.dtype | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = policy.cfg
        self.dtype = compute_dtype or torch.float32
        self.policy = copy.deepcopy(policy).to(device=self.device,
                                               dtype=self.dtype)
        self.policy.eval().requires_grad_(False)
        self.instruction_len = instruction_len
        self.reset_state(num_envs)

    def reset_state(self, num_envs: int) -> None:
        self.num_envs = num_envs
        self.global_map = init_global_map(num_envs, self.cfg.mapper,
                                          dtype=self.dtype,
                                          device=self.device)

    def keep(self, keep_indices: Sequence[int]) -> None:
        """Drop paused env slots from the device state."""
        idx = torch.as_tensor(list(keep_indices), dtype=torch.int64,
                              device=self.device)
        self.global_map = self.global_map.index_select(0, idx)
        self.num_envs = len(keep_indices)

    def batch_obs(self, observations: list[dict[str, Any]]
                  ) -> dict[str, torch.Tensor]:
        """Host-side stacking and upload. rgb and depth are cast to the
        compute dtype; gps and compass stay fp32 (coordinate math)."""
        tokens = []
        for o in observations:
            t = np.asarray(o["instruction"]["tokens"]
                           if isinstance(o["instruction"], dict)
                           else o["instruction"], np.int32)
            if t.shape[0] < self.instruction_len:
                t = np.pad(t, (0, self.instruction_len - t.shape[0]))
            tokens.append(t[: self.instruction_len])
        batch = {
            "instruction": np.stack(tokens),
            "rgb": np.stack([np.asarray(o["rgb"], np.float32)
                             for o in observations]),
            "depth": np.stack([np.asarray(o["depth"], np.float32)
                               for o in observations]),
            "gps": np.stack([np.asarray(o["gps"], np.float32)
                             for o in observations]),
            "compass": np.stack([np.asarray(o["compass"], np.float32)
                                 for o in observations]),
        }
        cast = {"rgb", "depth"}
        return {k: torch.from_numpy(v).to(
                    device=self.device, dtype=self.dtype if k in cast else None)
                for k, v in batch.items()}

    def update_map(self, obs_batch: dict[str, torch.Tensor],
                   masks) -> torch.Tensor:
        """One map-update step; returns the ego map in fp32 and keeps the
        updated global map on the device."""
        masks = torch.as_tensor(np.asarray(masks, np.float32),
                                device=self.device).to(self.dtype)
        with torch.no_grad():
            ego_map, self.global_map = self.policy.update_map(
                obs_batch, masks, self.global_map)
        return ego_map.to(torch.float32)
