"""Device-side rollout engine for collection and evaluation.

Port of the serving part of ``ws_mgmap_tpu/train/rollout.py``: the
decision step ``act`` (once every 3 simulator steps) and the map-only
step ``update_map`` (the other two), with the episode state they carry
on the device: the persistent global map, which each step updates in
place, and the recurrent hidden state. The instruction is encoded once
per episode: ``act`` re-runs the biLSTM only when the token batch
changes.
"""
from __future__ import annotations

import copy
from typing import Any, Sequence

import numpy as np
import torch

from ws_mgmap_tpu_torch.models.policy import BasePolicy, PolicyOutputs
from ws_mgmap_tpu_torch.ops.mapping import init_global_map
from ws_mgmap_tpu_torch.utils.device import resolve_device


class RolloutEngine:
    """compute_dtype: None = fp32 (parity with the reference's eval);
    ``torch.bfloat16`` = the reduced-precision rollout mode. Every floating
    weight and buffer, BN running statistics included, is cast before BN
    is folded into the fused convs, and the hidden state and global map
    are kept in that dtype. On the card, fp32 parity also needs
    ``torch.backends.cudnn.allow_tf32 = False``: by default PyTorch lets
    cuDNN run fp32 convolutions in TF32.

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

    # -- state -----------------------------------------------------------------
    def reset_state(self, num_envs: int) -> None:
        self.num_envs = num_envs
        self.hidden = torch.zeros((2, num_envs, self.cfg.hidden_size),
                                  dtype=self.dtype, device=self.device)
        self.global_map = init_global_map(num_envs, self.cfg.mapper,
                                          dtype=self.dtype,
                                          device=self.device)
        self.prev_actions = np.zeros((num_envs, 2), np.float32)
        self.prog = np.zeros((num_envs, 1), np.float32)
        # the per-episode text cache: the token batch it was encoded from
        # (on the host) and its (text, text_pad) on the device
        self._text_tokens: torch.Tensor | None = None
        self._text_cache: tuple[torch.Tensor, torch.Tensor] | None = None

    def zero_hidden_at(self, idx: int) -> None:
        """Zero one env's hidden state (the end of its look-around). Out
        of place: an earlier ``act``'s returned hidden stays as it was."""
        self.hidden = self.hidden.index_fill(
            1, torch.tensor([idx], device=self.device), 0)

    def keep(self, keep_indices: Sequence[int]) -> None:
        """Drop paused env slots from all state; the text cache is dropped
        too (its rows no longer match), so the next act re-encodes."""
        keep = list(keep_indices)
        idx = torch.as_tensor(keep, dtype=torch.int64, device=self.device)
        self.hidden = self.hidden.index_select(1, idx)
        self.global_map = self.global_map.index_select(0, idx)
        self.prev_actions = self.prev_actions[keep]
        self.prog = self.prog[keep]
        self.num_envs = len(keep)
        self._text_tokens = None

    # -- obs -------------------------------------------------------------------
    def batch_obs(self, observations: list[dict[str, Any]]
                  ) -> dict[str, torch.Tensor]:
        """Host-side stacking and upload. rgb and depth are cast to the
        compute dtype; gps and compass stay fp32 (coordinate math). The
        instruction tokens [B, instruction_len] (int32, 0-padded) stay on
        the host: ``act`` compares them with the cached batch there, and
        uploads them only when the biLSTM must run."""
        tokens = []
        for o in observations:
            t = np.asarray(o["instruction"]["tokens"]
                           if isinstance(o["instruction"], dict)
                           else o["instruction"], np.int32)
            if t.shape[0] < self.instruction_len:
                t = np.pad(t, (0, self.instruction_len - t.shape[0]))
            tokens.append(t[: self.instruction_len])
        batch = {
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
        out = {k: torch.from_numpy(v).to(
                   device=self.device, dtype=self.dtype if k in cast else None)
               for k, v in batch.items()}
        out["instruction"] = torch.from_numpy(np.stack(tokens))
        return out

    def _masks(self, masks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(masks, np.float32),
                               device=self.device).to(self.dtype)

    # -- steps -----------------------------------------------------------------
    def _with_text(self, obs_batch: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
        """``obs_batch`` with the cached text features, re-encoded only
        when the host token batch differs from the cached one."""
        tokens = obs_batch["instruction"]
        if (self._text_tokens is None
                or self._text_tokens.shape != tokens.shape
                or not torch.equal(self._text_tokens, tokens)):
            self._text_cache = self.policy.encode_text(tokens)
            self._text_tokens = tokens.clone()
        text, text_pad = self._text_cache
        return dict(obs_batch, text_features=text, text_pad=text_pad)

    def act(self, obs_batch: dict[str, torch.Tensor], masks
            ) -> PolicyOutputs:
        """One decision step (deterministic: the waypoint is the mode).
        Keeps the new hidden state and global map, copies ``prog`` to the
        host, and returns the outputs with action, prog, ego_map and the
        trunks' features in fp32 (what host consumers expect)."""
        with torch.no_grad():
            out = self.policy.act(self._with_text(obs_batch), self.hidden,
                                  self._masks(masks), self.global_map)
        out = out._replace(
            action=out.action.float(), prog=out.prog.float(),
            ego_map=out.ego_map.float(),
            rgb_features=out.rgb_features.float(),
            depth_features=out.depth_features.float())
        self.hidden = out.hidden
        self.global_map = out.global_map
        self.prog = out.prog.cpu().numpy()
        return out

    def update_map(self, obs_batch: dict[str, torch.Tensor],
                   masks) -> torch.Tensor:
        """One map-update step; returns the ego map in fp32 and keeps the
        updated global map on the device."""
        with torch.no_grad():
            ego_map, self.global_map = self.policy.update_map(
                obs_batch, self._masks(masks), self.global_map)
        return ego_map.to(torch.float32)
