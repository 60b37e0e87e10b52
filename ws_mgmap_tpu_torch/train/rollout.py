"""Device-side rollout engine for collection and evaluation.

Port of the serving part of ``ws_mgmap_tpu/train/rollout.py``: the
decision step ``act`` (once every 3 simulator steps) and the map-only
step ``update_map`` (the other two), with the episode state they carry
on the device: the persistent global map, which each step updates in
place, and the recurrent hidden state. The instruction is encoded once
per episode: ``act`` re-runs the biLSTM only when the token batch
changes.

One engine may split its env batch over several local devices, as the
JAX engine shards it over a ``dp`` mesh (``rollout.py:27-41, 99-163``):
each device holds its own copy of the weights and the state of a
contiguous chunk of the envs, and every step runs chunk by chunk, its
outputs gathered on the first device. No math crosses envs, so the
chunks compute what one device would.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Any, Sequence

import numpy as np
import torch

from ws_mgmap_tpu_torch.models.policy import BasePolicy, PolicyOutputs
from ws_mgmap_tpu_torch.ops.mapping import init_global_map
from ws_mgmap_tpu_torch.parallel.mesh import best_dp
from ws_mgmap_tpu_torch.utils import profiling
from ws_mgmap_tpu_torch.utils.device import resolve_device


def _on(device: torch.device):
    """The device's context for kernel launches (none on the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class RolloutEngine:
    """compute_dtype: None = fp32 (parity with the reference's eval);
    ``torch.bfloat16`` = the reduced-precision rollout mode. Every floating
    weight and buffer, BN running statistics included, is cast before BN
    is folded into the fused convs, and the hidden state and global map
    are kept in that dtype. On the card fused mode "auto" sends the
    fused conv sites of both dtypes (``fused_conv_active`` in
    ``ops/kernels/conv.py``) to the port's kernels, fp32 to the direct
    conv in fp32 FMA; fp32 parity also needs
    ``torch.backends.cudnn.allow_tf32 = False`` for the convs the gate
    leaves to cuDNN, which PyTorch lets run in TF32 by default.

    The engine keeps its own copy of ``policy`` on ``device`` (the card
    unless ``device="cpu"``), in eval mode. ``devices`` (2 or more, in
    place of ``device``) splits the env batch: each device gets its own
    copy of the weights, and a batch of B envs is cut into
    ``best_dp(B, len(devices))`` equal contiguous chunks, chunk j on
    ``devices[j]`` with its envs' hidden state, global map and text
    cache (fewer chunks, down to one, when B has no divisor that fits,
    as JAX's mesh falls back). Kernels launch once per chunk. Outputs,
    and ``hidden`` and ``global_map`` when read, are gathered on
    ``devices[0]``.
    """

    def __init__(self, policy: BasePolicy, num_envs: int,
                 instruction_len: int = 200,
                 compute_dtype: torch.dtype | None = None, device=None,
                 devices: Sequence | None = None):
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = ([resolve_device(d) for d in devices] if devices
                        else [resolve_device(device)])
        self.device = self.devices[0]
        self.cfg = policy.cfg
        self.dtype = compute_dtype or torch.float32
        self.policy = copy.deepcopy(policy).to(device=self.device,
                                               dtype=self.dtype)
        self.policy.eval().requires_grad_(False)
        self.replicas = [self.policy] + [copy.deepcopy(self.policy).to(d)
                                         for d in self.devices[1:]]
        self.instruction_len = instruction_len
        self.reset_state(num_envs)

    # -- state -----------------------------------------------------------------
    def _plan(self, n: int) -> list[tuple[int, int]]:
        """The env rows [start, stop) of each chunk, chunk j on
        ``devices[j]``."""
        dp = best_dp(n, len(self.devices)) if n else 1
        per = n // dp
        return [(j * per, (j + 1) * per) for j in range(dp)]

    def reset_state(self, num_envs: int) -> None:
        self.num_envs = num_envs
        self.chunks = self._plan(num_envs)
        self._hidden = [
            torch.zeros((2, b - a, self.cfg.hidden_size), dtype=self.dtype,
                        device=self.devices[j])
            for j, (a, b) in enumerate(self.chunks)]
        self._global = [
            init_global_map(b - a, self.cfg.mapper, dtype=self.dtype,
                            device=self.devices[j])
            for j, (a, b) in enumerate(self.chunks)]
        self.prev_actions = np.zeros((num_envs, 2), np.float32)
        self.prog = np.zeros((num_envs, 1), np.float32)
        # each chunk's text cache: the token batch it was encoded from (on
        # the host) and its (text, text_pad) on the chunk's device
        self._text_tokens: list[torch.Tensor | None] = [None] * len(
            self.chunks)
        self._text_cache: list[tuple[torch.Tensor, torch.Tensor] | None] = [
            None] * len(self.chunks)

    def _gather(self, parts: list[torch.Tensor], dim: int) -> torch.Tensor:
        if len(parts) == 1:
            return parts[0]
        return torch.cat([t.to(self.device) for t in parts], dim)

    def _split(self, value: torch.Tensor, dim: int) -> list[torch.Tensor]:
        if len(self.chunks) == 1:
            return [value]
        return [value.narrow(dim, a, b - a).to(self.devices[j])
                for j, (a, b) in enumerate(self.chunks)]

    @property
    def hidden(self) -> torch.Tensor:
        """[2, B, hidden] (gathered on the first device when split)."""
        return self._gather(self._hidden, 1)

    @hidden.setter
    def hidden(self, value: torch.Tensor) -> None:
        self._hidden = self._split(value, 1)

    @property
    def global_map(self) -> torch.Tensor:
        """[B, G, G, C] (gathered on the first device when split)."""
        return self._gather(self._global, 0)

    @global_map.setter
    def global_map(self, value: torch.Tensor) -> None:
        self._global = self._split(value, 0)

    def _locate(self, idx: int) -> tuple[int, int]:
        """(chunk, row within it) of env ``idx``."""
        for j, (a, b) in enumerate(self.chunks):
            if a <= idx < b:
                return j, idx - a
        raise IndexError(f"env {idx} of {self.num_envs}")

    def zero_hidden_at(self, idx: int) -> None:
        """Zero one env's hidden state (the end of its look-around). Out
        of place: an earlier ``act``'s returned hidden stays as it was."""
        j, row = self._locate(idx)
        self._hidden[j] = self._hidden[j].index_fill(
            1, torch.tensor([row], device=self.devices[j]), 0)

    def keep(self, keep_indices: Sequence[int]) -> None:
        """Drop paused env slots from all state, and cut the envs left
        into the chunks of their new count (JAX's ``_place_state``): a row
        moves between devices only when its chunk's device changes. The
        text caches are dropped too (their rows no longer match), so the
        next act re-encodes."""
        keep = list(keep_indices)
        owners = [self._locate(i) for i in keep]
        chunks = self._plan(len(keep))

        def regather(parts: list[torch.Tensor], dim: int
                     ) -> list[torch.Tensor]:
            out = []
            for j, (a, b) in enumerate(chunks):
                dev = self.devices[j]
                pieces = []
                for old, group in itertools.groupby(owners[a:b],
                                                    key=lambda o: o[0]):
                    rows = torch.as_tensor([r for _, r in group],
                                           device=parts[old].device)
                    pieces.append(parts[old].index_select(dim, rows).to(dev))
                if not pieces:  # no env left
                    pieces = [parts[0].narrow(dim, 0, 0).to(dev)]
                out.append(pieces[0] if len(pieces) == 1
                           else torch.cat(pieces, dim))
            return out

        self._hidden = regather(self._hidden, 1)
        self._global = regather(self._global, 0)
        self.chunks = chunks
        self.prev_actions = self.prev_actions[keep]
        self.prog = self.prog[keep]
        self.num_envs = len(keep)
        self._text_tokens = [None] * len(chunks)
        self._text_cache = [None] * len(chunks)

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
    def _chunk_obs(self, j: int, obs_batch: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
        """Chunk ``j``'s rows of the batch, on its device."""
        if len(self.chunks) == 1:
            return obs_batch
        if obs_batch["rgb"].shape[0] != self.num_envs:
            raise ValueError(f"a batch of {obs_batch['rgb'].shape[0]} envs "
                             f"for an engine holding {self.num_envs}")
        a, b = self.chunks[j]
        dev = self.devices[j]
        return {k: v[a:b] if k == "instruction" else v[a:b].to(dev)
                for k, v in obs_batch.items()}

    def _with_text(self, j: int, obs_batch: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
        """``obs_batch`` (chunk ``j``'s) with the cached text features,
        re-encoded only when the host token batch differs from the cached
        one."""
        tokens = obs_batch["instruction"]
        cached = self._text_tokens[j]
        if (cached is None or cached.shape != tokens.shape
                or not torch.equal(cached, tokens)):
            with profiling.span("engine.encode_text"):
                self._text_cache[j] = self.replicas[j].encode_text(tokens)
            self._text_tokens[j] = tokens.clone()
        text, text_pad = self._text_cache[j]
        return dict(obs_batch, text_features=text, text_pad=text_pad)

    @profiling.span("engine.act")
    def act(self, obs_batch: dict[str, torch.Tensor], masks
            ) -> PolicyOutputs:
        """One decision step (deterministic: the waypoint is the mode).
        Keeps the new hidden state and global map, copies ``prog`` to the
        host, and returns the outputs with action, prog, ego_map and the
        trunks' features in fp32 (what host consumers expect)."""
        masks = self._masks(masks)
        outs = []
        for j, (a, b) in enumerate(self.chunks):
            dev = self.devices[j]
            with _on(dev), torch.no_grad():
                obs = self._with_text(j, self._chunk_obs(j, obs_batch))
                out = self.replicas[j].act(obs, self._hidden[j],
                                           masks[a:b].to(dev),
                                           self._global[j])
            self._hidden[j] = out.hidden
            self._global[j] = out.global_map
            outs.append(out)
        out = outs[0] if len(outs) == 1 else PolicyOutputs(*(
            None if parts[0] is None
            else self._gather(list(parts), 1 if name == "hidden" else 0)
            for name, parts in zip(PolicyOutputs._fields, zip(*outs))))
        out = out._replace(
            action=out.action.float(), prog=out.prog.float(),
            ego_map=out.ego_map.float(),
            rgb_features=out.rgb_features.float(),
            depth_features=out.depth_features.float())
        self.prog = out.prog.cpu().numpy()
        return out

    @profiling.span("engine.update_map")
    def update_map(self, obs_batch: dict[str, torch.Tensor],
                   masks) -> torch.Tensor:
        """One map-update step; returns the ego map in fp32 and keeps the
        updated global map on the device."""
        masks = self._masks(masks)
        egos = []
        for j, (a, b) in enumerate(self.chunks):
            dev = self.devices[j]
            with _on(dev), torch.no_grad():
                ego, self._global[j] = self.replicas[j].update_map(
                    self._chunk_obs(j, obs_batch), masks[a:b].to(dev),
                    self._global[j])
            egos.append(ego)
        return self._gather(egos, 0).to(torch.float32)
