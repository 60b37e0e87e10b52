"""Data parallelism over ``torch.distributed``.

The port of the parts of ``ws_mgmap_tpu/parallel/mesh.py`` that the
data-parallel update uses. In JAX one jitted update over a ``dp`` mesh
computes the update of the *global* batch: BatchNorm statistics over
every shard's frames, loss normalisers over the global batch and one
gradient. Here each rank is one process with one card (NCCL) or one CPU
process (gloo); it holds its own shard of the batch, and the reductions
below let the train-mode BatchNorm (``models/layers.py``), the losses
(``train/losses.py``) and the update (``train/step.py``) compute the
global quantities.

Without a process group each reduction is the identity. Over a group of
one rank each still issues its collective (whose value is its input), so
a one-rank group measures what the collectives cost.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Iterable

import torch
import torch.distributed as dist

from ws_mgmap_tpu_torch.utils.device import resolve_device


def group_active() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(device=None, init_method: str = "env://",
                     timeout_s: float = 600.0, backend: str | None = None
                     ) -> tuple[int, int, torch.device]:
    """Joins the process group of ``WORLD_SIZE`` ranks as rank ``RANK``
    (both from the environment, as ``run.py`` reads them; ``RANK``
    defaults to ``LOCAL_RANK``, which torchrun sets) and returns (rank,
    world size, this rank's device).

    On the card (``device=None``) the rank takes card ``LOCAL_RANK`` and
    the group runs NCCL; without a card this raises, as
    :func:`resolve_device` does. Only ``device="cpu"`` runs gloo on the
    CPU. ``init_method`` is where the ranks meet (``env://``: torchrun's
    ``MASTER_ADDR`` and ``MASTER_PORT``; ``file://<path>``: a file store).
    A collective that waits longer than ``timeout_s`` fails.
    ``backend="gloo"`` on the card lets ranks share one card (NCCL
    refuses two ranks on one card)."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", str(local_rank)))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu" and backend in (None, "gloo"):
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend {backend} for {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world, dev


def dp_size() -> int:
    """The number of data-parallel ranks: the group's size, 1 without
    one."""
    return dist.get_world_size() if group_active() else 1


def best_dp(batch_size: int, max_devices: int | None = None) -> int:
    """Largest device count that evenly divides the episode batch."""
    n = max_devices or dp_size()
    for d in range(min(n, batch_size), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


def shard_batch(batch: Any, rank: int, world: int) -> Any:
    """Rank ``rank``'s contiguous slice of a global host batch: every leaf
    (nested dicts of arrays or tensors) cut into ``world`` equal parts on
    its leading (episode) axis, as the JAX check hands each process its
    half."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} episodes does not split over "
                         f"{world} ranks")
    per = n // world
    return batch[per * rank: per * (rank + 1)]


def _broadcast_(t: torch.Tensor) -> None:
    """Rank 0's ``t`` into ``t`` on every rank (through the card when the
    group is NCCL and ``t`` is on the host)."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        tmp = t.cuda()
        dist.broadcast(tmp, 0)
        t.copy_(tmp)
    else:
        dist.broadcast(t, 0)


@torch.no_grad()
def replicate(obj: torch.nn.Module | torch.optim.Optimizer) -> None:
    """Every rank takes rank 0's parameters and buffers (a module) or
    state (an optimizer), in place, so the ranks start equal. Every rank
    must hold the same structure (for an optimizer: the same state
    entries)."""
    if not group_active():
        return
    if isinstance(obj, torch.optim.Optimizer):
        tensors = [v for state in obj.state.values() for v in state.values()
                   if torch.is_tensor(v)]
    else:
        tensors = list(obj.state_dict(keep_vars=True).values())
    for t in tensors:
        _broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t)


class _SumAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumAllReduce.apply(grad)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: its backward is
    itself a SUM all-reduce of the incoming gradient, so rank r's input
    gets the gradient of every rank's loss."""
    return _SumAllReduce.apply(t) if group_active() else t


@torch.no_grad()
def _reduced(t: torch.Tensor, op) -> torch.Tensor:
    if not group_active():
        return t.detach()
    out = t.detach().clone()
    dist.all_reduce(out, op=op)
    return out


def sum_no_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, detached."""
    return _reduced(t, dist.ReduceOp.SUM)


def max_no_grad(t: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks, detached (a min is the
    max of the negated values)."""
    return _reduced(t, dist.ReduceOp.MAX)


@torch.no_grad()
def sum_gradients_(params: Iterable[torch.nn.Parameter]) -> None:
    """Replaces each gradient by its sum over the ranks, in one coalesced
    SUM all-reduce (a SUM, not DDP's mean: each rank's loss is its part of
    one global loss). Parameters without a gradient are left out; every
    rank must have gradients on the same parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or not group_active():
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
