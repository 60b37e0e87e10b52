"""The teacher-forcing update (port of ``ws_mgmap_tpu/train/step.py``).

One update runs ``BasePolicy.forward_seq`` in train mode over an
episode-major batch (the encoders over all N*T frames, the recurrent core
over T), the loss of :func:`losses.total_loss`, the backward pass, and one
Adam step (optax's defaults: lr 2.5e-4, betas 0.9 / 0.999, eps 1e-8) on
the trainable parameters. The frozen trunks (``FROZEN_PREFIXES``: the
whole UNet and the whole depth encoder, its spatial embeddings included)
get no gradient and no update, as optax's ``set_to_zero`` gives them in
JAX. The map modules' BatchNorm statistics move once per update.

Where JAX's step is a pure function of its state, the port's state is the
policy (parameters and BN statistics), the optimizer (Adam's moments) and
the update count, and :func:`make_train_step`'s update changes it in place.

``make_train_step(..., distributed=True)`` is JAX's ``jit_train_step``
over a ``dp`` mesh: each rank of the process group (``parallel/mesh.py``)
updates on its shard of the global batch, and together they compute the
global batch's update: train-mode BatchNorm over every rank's frames
(``layers.global_batch_stats``), the losses over the global normalisers
(``losses.total_loss(..., distributed=True)``), and one SUM all-reduce of
the gradients, after which Adam steps identically on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ws_mgmap_tpu_torch.models.layers import (bn_stats_frozen,
                                              global_batch_stats)
from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.parallel import mesh
from ws_mgmap_tpu_torch.train.losses import MonitorConfig, total_loss
from ws_mgmap_tpu_torch.utils import profiling
from ws_mgmap_tpu_torch.utils.device import resolve_device

FROZEN_PREFIXES = ("net.rgb_encoder.", "net.depth_encoder.")

# the recurrent state is [2, N, H]: GRU1 and GRU2
NUM_RECURRENT_LAYERS = 2


def trainable(name: str) -> bool:
    """Whether the parameter ``name`` (a ``named_parameters`` key) trains."""
    return not name.startswith(FROZEN_PREFIXES)


def make_optimizer(policy: BasePolicy, lr: float = 2.5e-4
                   ) -> torch.optim.Adam:
    """Adam(lr) over the trainable parameters of ``policy``."""
    params = [p for name, p in policy.named_parameters() if trainable(name)]
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """What one update changes: ``policy`` (parameters and BN
    statistics), ``optimizer`` and ``step`` (updates done)."""

    policy: BasePolicy
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.policy.parameters()).device


def create_train_state(policy: BasePolicy, lr: float = 2.5e-4,
                       device=None) -> TrainState:
    """Moves ``policy`` to ``device`` (the card unless ``device="cpu"``),
    puts it in train mode, turns off the frozen parameters' gradients and
    builds Adam over the others. The state trains ``policy`` itself."""
    policy.to(resolve_device(device)).train()
    for name, p in policy.named_parameters():
        p.requires_grad_(trainable(name))
    return TrainState(policy, make_optimizer(policy, lr))


def upload_batch(batch: dict[str, Any], device: torch.device
                 ) -> dict[str, Any]:
    """A collated batch (numpy or tensors) on ``device``; the instruction
    tokens stay on the host, where the biLSTM reads its step count without
    a sync.

    A leaf in page-locked memory (the loader's slabs where CUDA is
    present) is copied without blocking the host, on the current stream,
    so the work queued after it waits for it and the host does not; any
    other leaf as a blocking copy. ``upload_batch.pinned_bytes`` and
    ``.pageable_bytes`` count the bytes copied from each kind of memory.
    """
    device = torch.device(device)

    def put(k, v):
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        if k == "instruction":
            return t
        if t.device.type != "cpu" or device.type == "cpu":
            return t.to(device)  # no copy from the host
        pinned = t.is_pinned()
        if pinned:
            upload_batch.pinned_bytes += t.nbytes
        else:
            upload_batch.pageable_bytes += t.nbytes
        return t.to(device, non_blocking=pinned)

    out = {k: put(k, v) for k, v in batch.items() if k != "obs"}
    out["obs"] = {k: put(k, v) for k, v in batch["obs"].items()}
    return out


upload_batch.pinned_bytes = 0
upload_batch.pageable_bytes = 0


def make_train_step(monitors: MonitorConfig, remat: bool = False,
                    distributed: bool = False
                    ) -> Callable[[TrainState, dict[str, Any]],
                                  dict[str, torch.Tensor]]:
    """Returns update(state, batch) -> metrics (0-dim tensors on the
    state's device), which changes ``state`` in place.

    batch: {"obs": {leaf: [N, T, ...]}, "weights": [N, T] (0 on padding),
    "not_done_masks": [N, T] (0 at episode starts)}, as
    :func:`replay.collate_episodes` builds it. The hidden state starts at
    zero.

    ``remat=True`` checkpoints the whole forward (non-reentrant
    ``torch.utils.checkpoint``, JAX's ``jax.checkpoint``): the backward
    pass recomputes it. The recompute normalizes with the same batch
    statistics but leaves the running ones alone, so they move once per
    update, as in JAX.

    ``distributed=True``: ``batch`` is this rank's shard of the global
    batch (every rank's of the same shape: the loader's ``fixed_len``),
    and the process group must be initialized
    (:func:`mesh.init_distributed`), with every rank's state equal
    (:func:`mesh.replicate`). The metrics are the global batch's. Every
    rank issues the same collectives in the same order: the BatchNorm
    layers' in module order, the losses' three, then, in the backward, the
    BatchNorm layers' again in reverse (with ``remat``, the recompute's
    forward ones first), and last the gradients' one bucket.
    """
    if distributed and not mesh.group_active():
        raise RuntimeError("distributed=True needs a process group: call "
                           "mesh.init_distributed first")

    @profiling.span("train.update")
    def update(state: TrainState, batch: dict[str, Any]
               ) -> dict[str, torch.Tensor]:
        policy = state.policy.train()
        batch = upload_batch(batch, state.device)
        obs, weights = batch["obs"], batch["weights"]
        masks = batch["not_done_masks"]
        h0 = weights.new_zeros(NUM_RECURRENT_LAYERS, weights.shape[0],
                               policy.cfg.hidden_size)

        def forward(obs):
            return policy.forward_seq(obs, h0, masks)

        with (global_batch_stats(policy) if distributed
              else contextlib.nullcontext()):
            if remat:
                pred, aux_out = checkpoint(
                    forward, obs, use_reentrant=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        bn_stats_frozen(policy)))
            else:
                pred, aux_out = forward(obs)
            loss, metrics = total_loss(pred, aux_out, obs, weights, monitors,
                                       distributed)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if distributed:
            mesh.sum_gradients_(p for group in state.optimizer.param_groups
                                for p in group["params"])
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return update
