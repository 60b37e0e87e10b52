"""Checkpoints (port of ``ws_mgmap_tpu/train/checkpoint.py``).

Policy checkpoints keep the reference's ``{state_dict, config,
extra_state}`` ``ckpt.<index>.pth`` format, so the JAX package and the
port read each other's files. A file the JAX package wrote differs from
the port's ``state_dict`` in two ways, which :func:`restore` takes in: its
two attention key layers are [out, in] (torch's ``Conv1d`` keeps [out,
in, 1]) and it has no ``num_batches_tracked``. The full training state
(policy, Adam and the update count, for an exact resume) is the port's
own file: :func:`save_native` / :func:`load_native`.
"""
from __future__ import annotations

import os
import re
from typing import Any

import torch

from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.train.step import TrainState
from ws_mgmap_tpu_torch.utils.convert import CONV1D_WEIGHTS


def save_checkpoint(path: str, policy: BasePolicy, config: Any = None,
                    extra_state: dict[str, Any] | None = None) -> None:
    """``policy``'s state_dict (on the CPU), and ``config`` (its
    ``to_dict()`` where it has one) and ``extra_state`` where given."""
    sd = {k: v.detach().cpu() for k, v in policy.state_dict().items()}
    blob: dict[str, Any] = {"state_dict": sd}
    if config is not None:
        blob["config"] = (config.to_dict() if hasattr(config, "to_dict")
                          else config)
    if extra_state is not None:
        blob["extra_state"] = extra_state
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(blob, path)


def load_checkpoint(path: str) -> dict[str, Any]:
    """The checkpoint's blob, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def restore(policy: BasePolicy, path: str, strict: bool = False
            ) -> dict[str, Any]:
    """Load a ``ckpt.*.pth`` (the port's, the JAX package's or the
    reference's) into ``policy``; returns the blob. Missing and unexpected
    keys are reported and tolerated, as the reference's strict=False loads
    are, unless ``strict``."""
    blob = load_checkpoint(path)
    load_policy_state(policy, blob["state_dict"], strict)
    return blob


def load_policy_state(policy: BasePolicy, state_dict: dict[str, Any],
                      strict: bool = False) -> None:
    """A checkpoint's ``state_dict`` (the port's, the JAX package's or the
    reference's) into ``policy``, as :func:`restore` loads it."""
    sd = dict(state_dict)
    own = policy.state_dict()
    for k, v in list(sd.items()):
        if k.endswith(CONV1D_WEIGHTS) and k in own and v.dim() == 2:
            sd[k] = v[..., None]
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros_like(v)
    missing, unexpected = policy.load_state_dict(sd, strict=strict)
    if missing or unexpected:
        print(f"[checkpoint] missing keys: {missing[:8]}"
              f"{'...' if len(missing) > 8 else ''}; unexpected: "
              f"{unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")


def save_native(path: str, state: TrainState) -> None:
    """The full training state in one file: the policy's state_dict (BN
    statistics included), Adam's state and the update count."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"policy": state.policy.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, path)


def load_native(path: str, state: TrainState) -> TrainState:
    """Load :func:`save_native`'s file into ``state`` (built for the same
    configuration, on any device); returns it."""
    blob = torch.load(path, map_location=state.device, weights_only=True)
    state.policy.load_state_dict(blob["policy"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state


def latest_checkpoint(folder: str) -> str | None:
    """The newest file in ``folder`` by mtime, as the reference resumes."""
    if not os.path.isdir(folder):
        return None
    files = [os.path.join(folder, f) for f in os.listdir(folder)]
    files = [f for f in files if os.path.isfile(f)]
    if not files:
        return None
    return max(files, key=os.path.getmtime)


def parse_resume_point(blob: dict[str, Any], ckpt_file: str,
                       epochs_per_iter: int) -> tuple[int, int]:
    """(dagger_it, start_epoch) as the reference's ``resume_dagger``
    reconstructs them: dagger_it from ``extra_state``, the epoch from the
    ``ckpt.<index>.pth`` name, rolling over to the next iteration when an
    iteration's last epoch was saved."""
    dagger_it = int(blob.get("extra_state", {}).get("dagger_it", 0))
    m = re.search(r"ckpt\.(\d+)\.pth$", ckpt_file)
    if not m:
        return dagger_it, 0
    start_epoch = (int(m.group(1)) + 1) % epochs_per_iter
    if start_epoch == 0:
        dagger_it += 1
    return dagger_it, start_epoch
