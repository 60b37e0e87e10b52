"""Imitation and auxiliary losses (port of ``ws_mgmap_tpu/train/losses.py``).

Every monitor returns a per-sample loss vector; :func:`reduce_aux` applies
the validity mask and the alpha weights. Tensors are episode-major
([N, T, ...]); the semantic logits are NHWC.
"""
from __future__ import annotations

import dataclasses

import torch

from ws_mgmap_tpu_torch.ops.pooling import (interpolate_area_nhwc,
                                            interpolate_nearest_nhwc)


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
                weights: torch.Tensor) -> torch.Tensor:
    """Weighted waypoint MSE: pred_mean [N, T, 2] (the raw Gaussian mean),
    waypoint [N, T, 2], weights [N, T] (0 on padding);
    mean_n(sum_t w * mse / sum_t w)."""
    per_step = ((torch.tanh(pred_mean) - waypoint) ** 2).sum(-1)
    per_ep = (weights * per_step).sum(1) / weights.sum(1).clamp(min=1e-8)
    return per_ep.mean()


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
                        tau: float) -> torch.Tensor:
    """KL(softened GT-path distribution || text-to-map attention):
    att_map [B, S] (a softmax already), dis_map [B, E, E] the distance
    transform of the GT path. Returns [B]. The distance map is normalised
    by the max and min of the whole batch, as the reference does."""
    feature_size = int(round(att_map.shape[-1] ** 0.5))
    d = dis_map.float()
    dmax, dmin = d.max(), d.min()
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
               mask: torch.Tensor) -> torch.Tensor:
    """The masked, weighted sum of per-sample monitors, summed in key
    order: losses name -> (per_sample [B], alpha); mask [B] bool."""
    total = 0.0
    denom = mask.float().sum().clamp(min=1e-8)
    for _, (vec, alpha) in sorted(losses.items()):
        total = total + alpha * (vec * mask.to(vec.dtype)).sum() / denom
    return total


def total_loss(pred_mean: torch.Tensor, aux_out: dict[str, torch.Tensor],
               batch: dict[str, torch.Tensor], weights: torch.Tensor,
               mon: MonitorConfig
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The teacher-forcing objective: the action loss plus the monitors
    whose switch is on and whose target the batch (episode-major obs,
    ``waypoint`` [N, T, 2] included) holds. Returns (loss, metrics)."""
    n, t = weights.shape
    a_loss = action_loss(pred_mean, batch["waypoint"][..., :2], weights)

    flat_mask = (weights > 0).reshape(n * t)
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
                mon.contrastive_tau),
            mon.contrastive_alpha)
    if mon.progress and "progress" in batch:
        aux["progress_monitor"] = (
            progress_monitor(aux_out["prog"].reshape(n * t, 1),
                             batch["progress"].reshape(n * t, -1)[:, :1]),
            mon.progress_alpha)

    aux_total = (reduce_aux(aux, flat_mask) if aux
                 else a_loss.new_zeros(()))
    loss = a_loss + aux_total
    metrics = {"loss": loss, "action_loss": a_loss, "aux_loss": aux_total}
    count = flat_mask.float().sum().clamp(min=1e-8)
    for k, (vec, _) in aux.items():
        metrics[k] = (vec * flat_mask).sum() / count
    return loss, metrics
