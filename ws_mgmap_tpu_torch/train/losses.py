"""Imitation and auxiliary losses (port of ``ws_mgmap_tpu/train/losses.py``).

Every monitor returns a per-sample loss vector; :func:`reduce_aux` applies
the validity mask and the alpha weights. Tensors are episode-major
([N, T, ...]); the semantic logits are NHWC.

In the data-parallel update (``total_loss(..., distributed=True)``) each
rank holds a shard of the global batch and returns its part of the
global loss: its sums over the global normalisers (the episode count,
the masked frame count, the contrastive target's max and min), so the
ranks' parts sum to the loss of the global batch. The normalisers come
from collectives that every rank issues in the same order whatever its
shard holds.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ws_mgmap_tpu_torch.ops.pooling import (interpolate_area_nhwc,
                                            interpolate_nearest_nhwc)
from ws_mgmap_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Monitor switches and weights (the reference's ``MODEL.*_MONITOR``)."""

    progress: bool = True
    progress_alpha: float = 1.0
    contrastive: bool = True
    contrastive_alpha: float = 1.0
    contrastive_tau: float = 0.07
    prediction: bool = True
    prediction_alpha: float = 0.1

    @classmethod
    def from_config(cls, model_cfg) -> "MonitorConfig":
        """From a yacs-like ``MODEL`` node, read by attribute."""
        m = model_cfg
        return cls(
            progress=m.PROGRESS_MONITOR.use,
            progress_alpha=m.PROGRESS_MONITOR.alpha,
            contrastive=m.CONTRASTIVE_MONITOR.use,
            contrastive_alpha=m.CONTRASTIVE_MONITOR.alpha,
            contrastive_tau=m.CONTRASTIVE_MONITOR.target_tau,
            prediction=m.PREDICTION_MONITOR.use,
            prediction_alpha=m.PREDICTION_MONITOR.alpha,
        )


def action_loss(pred_mean: torch.Tensor, waypoint: torch.Tensor,
                weights: torch.Tensor,
                n_total: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted waypoint MSE: pred_mean [N, T, 2] (the raw Gaussian mean),
    waypoint [N, T, 2], weights [N, T] (0 on padding);
    mean_n(sum_t w * mse / sum_t w). With ``n_total`` (the global episode
    count), the sum over these episodes divided by it."""
    per_step = ((torch.tanh(pred_mean) - waypoint) ** 2).sum(-1)
    per_ep = (weights * per_step).sum(1) / weights.sum(1).clamp(min=1e-8)
    return per_ep.mean() if n_total is None else per_ep.sum() / n_total


def prediction_monitor(pred_sem_map: torch.Tensor,
                       gt_semantic_map: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the hallucinated semantics against the GT map,
    resampled to the logits' side by nearest: pred_sem_map [B, h, w, K]
    logits, gt_semantic_map [B, E, E] int. Returns [B]."""
    tgt = interpolate_nearest_nhwc(gt_semantic_map[..., None],
                                   pred_sem_map.shape[1:3])
    logp = torch.log_softmax(pred_sem_map, -1)
    ce = -logp.gather(-1, tgt.long())[..., 0]
    return ce.mean((1, 2))


def contrastive_monitor(att_map: torch.Tensor, dis_map: torch.Tensor,
                        tau: float,
                        d_range: tuple[torch.Tensor, torch.Tensor] | None
                        = None) -> torch.Tensor:
    """KL(softened GT-path distribution || text-to-map attention):
    att_map [B, S] (a softmax already), dis_map [B, E, E] the distance
    transform of the GT path. Returns [B]. The distance map is normalised
    by the max and min of the whole batch, as the reference does
    (``d_range`` = (max, min) of the global batch, when given)."""
    feature_size = int(round(att_map.shape[-1] ** 0.5))
    d = dis_map.float()
    dmax, dmin = (d.max(), d.min()) if d_range is None else d_range
    target = (dmax - d) / (dmax - dmin).clamp(min=1e-8)
    target = interpolate_area_nhwc(target[..., None],
                                   (feature_size, feature_size))[..., 0]
    target = torch.softmax(target.reshape(target.shape[0], -1) / tau, 1)
    log_pred = torch.log(att_map.clamp(min=1e-30))
    kl = target * (torch.log(target.clamp(min=1e-30)) - log_pred)
    kl = torch.where(target > 0, kl, kl.new_zeros(()))
    return kl.mean(-1)


def progress_monitor(prog: torch.Tensor, progress_target: torch.Tensor
                     ) -> torch.Tensor:
    """MSE of the tanh progress head against the oracle progress."""
    return ((prog - progress_target.reshape(prog.shape)) ** 2).mean(-1)


def reduce_aux(losses: dict[str, tuple[torch.Tensor, float]],
               mask: torch.Tensor,
               denom: torch.Tensor | None = None) -> torch.Tensor:
    """The masked, weighted sum of per-sample monitors, summed in key
    order: losses name -> (per_sample [B], alpha); mask [B] bool. Each
    masked sum is divided by ``denom``: the global masked count, or by
    default this mask's."""
    total = 0.0
    if denom is None:
        denom = mask.float().sum().clamp(min=1e-8)
    for _, (vec, alpha) in sorted(losses.items()):
        total = total + alpha * (vec * mask.to(vec.dtype)).sum() / denom
    return total


MONITORS = ("prediction_monitor", "contrastive_monitor", "progress_monitor")


def _switched_on(mon: MonitorConfig) -> list[str]:
    return [name for name, on in zip(
        MONITORS, (mon.prediction, mon.contrastive, mon.progress)) if on]


def total_loss(pred_mean: torch.Tensor, aux_out: dict[str, torch.Tensor],
               batch: dict[str, torch.Tensor], weights: torch.Tensor,
               mon: MonitorConfig, distributed: bool = False
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The teacher-forcing objective: the action loss plus the monitors
    whose switch is on and whose target the batch (episode-major obs,
    ``waypoint`` [N, T, 2] included) holds. Returns (loss, metrics).

    ``distributed``: this batch is one rank's shard. The loss is then this
    rank's part of the global batch's loss, and the metrics (detached) are
    the global batch's, the same on every rank. Three collectives, in this
    order on every rank: the SUM of the episode and masked frame counts,
    the MAX of the GT path's max and negated min (when the contrastive
    monitor is on), the SUM of the metrics' parts."""
    n, t = weights.shape
    flat_mask = (weights > 0).reshape(n * t)
    n_total = count = d_range = None
    if distributed:
        counts = mesh.sum_no_grad(torch.stack(
            [weights.new_tensor(float(n)), flat_mask.to(weights.dtype).sum()]))
        n_total, count = counts[0], counts[1].clamp(min=1e-8)
        if mon.contrastive:
            d = batch["gt_path"].float() if "gt_path" in batch else None
            r = mesh.max_no_grad(
                torch.full((2,), -math.inf, device=weights.device)
                if d is None else torch.stack([d.max(), -d.min()]))
            d_range = (r[0], -r[1])

    a_loss = action_loss(pred_mean, batch["waypoint"][..., :2], weights,
                         n_total)
    aux = {}
    if mon.prediction and "gt_semantic_map" in batch:
        ps = aux_out["pred_sem_map"]
        aux["prediction_monitor"] = (
            prediction_monitor(
                ps.reshape(n * t, *ps.shape[2:]),
                batch["gt_semantic_map"].reshape(
                    n * t, *batch["gt_semantic_map"].shape[2:])),
            mon.prediction_alpha)
    if mon.contrastive and "gt_path" in batch:
        aux["contrastive_monitor"] = (
            contrastive_monitor(
                aux_out["att_map"].reshape(n * t, -1),
                batch["gt_path"].reshape(n * t, *batch["gt_path"].shape[2:]),
                mon.contrastive_tau, d_range),
            mon.contrastive_alpha)
    if mon.progress and "progress" in batch:
        aux["progress_monitor"] = (
            progress_monitor(aux_out["prog"].reshape(n * t, 1),
                             batch["progress"].reshape(n * t, -1)[:, :1]),
            mon.progress_alpha)

    aux_total = (reduce_aux(aux, flat_mask, count) if aux
                 else a_loss.new_zeros(()))
    loss = a_loss + aux_total
    if distributed:
        names = _switched_on(mon)
        masked = [(aux[k][0] * flat_mask).sum() if k in aux
                  else loss.new_zeros(()) for k in names]
        parts = mesh.sum_no_grad(torch.stack(
            [loss, a_loss, aux_total] + [m.to(loss.dtype) for m in masked]))
        metrics = {"loss": parts[0], "action_loss": parts[1],
                   "aux_loss": parts[2]}
        for k, v in zip(names, parts[3:]):
            if k in aux:
                metrics[k] = v / count
        return loss, metrics
    metrics = {"loss": loss, "action_loss": a_loss, "aux_loss": aux_total}
    count = flat_mask.float().sum().clamp(min=1e-8)
    for k, (vec, _) in aux.items():
        metrics[k] = (vec * flat_mask).sum() / count
    return loss, metrics
