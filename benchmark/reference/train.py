"""The teacher-forcing update in plain PyTorch: the replay batches as
the trainer's loader orders and collates them, the policy over an
episode-major batch in train mode, the imitation loss and its three
monitors, and Adam over the trainable leaves."""
from __future__ import annotations

import random

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import policy as P

FROZEN_PREFIXES = ("net.rgb_encoder.", "net.depth_encoder.")
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


def trainable(name: str) -> bool:
    return not name.startswith(FROZEN_PREFIXES)


# -- batches ---------------------------------------------------------------------
def epoch_batches(n_records: int, batch: int, seed: int) -> list[list[int]]:
    """The record indices of each batch of one epoch: blocks of ``batch``
    consecutive records, the blocks shuffled by ``random.Random(seed)``,
    a short last block dropped."""
    blocks = [list(range(i, min(i + batch, n_records)))
              for i in range(0, n_records, batch)]
    random.Random(seed).shuffle(blocks)
    return [b for b in blocks if len(b) == batch]


def collate(episodes: list[dict], max_len: int, bucket: int = 16) -> dict:
    """Episodes sorted by length (stable), padded with 1.0 to T (the
    longest rounded up to ``bucket``, at most ``max_len``) and stacked
    episode-major; float16 leaves come back as float32. Weights are 0 on
    padding, not-done masks 0 at t = 0."""
    episodes = sorted(episodes, key=lambda e: e["prev_actions"].shape[0])
    lens = [e["prev_actions"].shape[0] for e in episodes]
    t = min(-(-min(max(lens), max_len) // bucket) * bucket, max_len)

    def pad(a, fill):
        a = np.asarray(a)[:t]
        if a.shape[0] < t:
            a = np.concatenate([a, np.full((t - a.shape[0],) + a.shape[1:],
                                           fill, a.dtype)])
        return a

    obs = {}
    for k in episodes[0]["obs"]:
        v = np.stack([pad(e["obs"][k], 1.0) for e in episodes])
        obs[k] = v.astype(np.float32) if v.dtype == np.float16 else v
    weights = np.zeros((len(episodes), t), np.float32)
    for i, n in enumerate(lens):
        weights[i, :min(n, t)] = 1.0
    masks = np.ones((len(episodes), t), np.float32)
    masks[:, 0] = 0.0
    return {"obs": obs, "weights": weights, "not_done_masks": masks}


# -- the forward pass and the loss ---------------------------------------------------
def forward_seq(sd, cfg, obs, masks):
    """(waypoint mean [N, T, 2], prog [N, T, 1], pred_sem [N*T, h, w, K],
    att_map [N*T, S]) in train mode from cached trunk features."""
    n, t = masks.shape
    flat = {k: v.reshape(n * t, *v.shape[2:]) for k, v in obs.items()}
    text, text_pad = P.encode_text(sd, flat["instruction"])
    map_in, map_emb, pred_sem = P.encode_map(sd, flat["rgb_ego_map"],
                                             train=True)
    state_in = torch.cat([P.rgb_in(sd, flat["rgb_features"]),
                          P.depth_in(sd, flat["depth_features"]), map_in], 1)

    def split(x):
        return x.reshape(n, t, *x.shape[1:])

    h = cfg["hidden_size"]
    h1 = state_in.new_zeros(n, h)
    h2 = state_in.new_zeros(n, h)
    s_in, m_emb, txt, pad = (split(x) for x in (state_in, map_emb, text,
                                                 text_pad))
    feats, atts = [], []
    for k in range(t):
        h2, h1, att = P.core(sd, cfg, s_in[:, k], m_emb[:, k], txt[:, k],
                             pad[:, k], h1, h2, masks[:, k])
        feats.append(h2)
        atts.append(att)
    features = torch.stack(feats, 1)
    mean, prog = P.heads(sd, features)
    return mean, prog, pred_sem, torch.stack(atts, 1).reshape(n * t, -1)


def nearest(x, out_hw):
    """Nearest resampling of NHWC ``x``: source index floor(dst * in/out),
    the product in fp32."""
    h, w = x.shape[1:3]
    oh, ow = out_hw
    iy = np.floor(np.arange(oh, dtype=np.float32) * np.float32(h / oh))
    ix = np.floor(np.arange(ow, dtype=np.float32) * np.float32(w / ow))
    iy = torch.from_numpy(iy.astype(np.int64)).to(x.device)
    ix = torch.from_numpy(ix.astype(np.int64)).to(x.device)
    return x[:, iy[:, None], ix[None, :]]


def loss(sd, cfg, batch, monitors: dict) -> torch.Tensor:
    """The waypoint MSE (tanh of the mean, averaged per episode over its
    valid steps, then over episodes) plus the progress, contrastive and
    prediction monitors over the valid frames."""
    obs, weights = batch["obs"], batch["weights"]
    n, t = weights.shape
    mean, prog, pred_sem, att = forward_seq(sd, cfg, obs,
                                            batch["not_done_masks"])
    per_step = ((torch.tanh(mean) - obs["waypoint"][..., :2]) ** 2).sum(-1)
    a_loss = ((weights * per_step).sum(1)
              / weights.sum(1).clamp(min=1e-8)).mean()
    mask = (weights > 0).reshape(-1).float()
    count = mask.sum().clamp(min=1e-8)
    aux = {}
    gt = obs["gt_semantic_map"].reshape(n * t, *obs["gt_semantic_map"].shape[2:])
    tgt = nearest(gt[..., None], pred_sem.shape[1:3])
    logp = torch.log_softmax(pred_sem, -1)
    aux["prediction_monitor"] = (-logp.gather(-1, tgt.long())[..., 0].mean(
        (1, 2)), monitors["prediction_alpha"])
    d = obs["gt_path"].reshape(n * t, *obs["gt_path"].shape[2:]).float()
    side = int(round(att.shape[-1] ** 0.5))
    target = (d.max() - d) / (d.max() - d.min()).clamp(min=1e-8)
    target = F.adaptive_avg_pool2d(target[:, None], (side, side))[:, 0]
    target = torch.softmax(target.reshape(n * t, -1)
                           / monitors["contrastive_tau"], 1)
    kl = target * (torch.log(target.clamp(min=1e-30))
                   - torch.log(att.clamp(min=1e-30)))
    kl = torch.where(target > 0, kl, kl.new_zeros(()))
    aux["contrastive_monitor"] = (kl.mean(-1), monitors["contrastive_alpha"])
    prog_t = obs["progress"].reshape(n * t, -1)[:, :1]
    aux["progress_monitor"] = (((prog.reshape(n * t, 1) - prog_t) ** 2)
                               .mean(-1), monitors["progress_alpha"])
    total = a_loss
    for _, (vec, alpha) in sorted(aux.items()):
        total = total + alpha * (vec * mask).sum() / count
    return total


# -- the optimiser -------------------------------------------------------------------
def follow(sd0: dict, cfg: dict, batches: list[dict], lr: float,
           monitors: dict, device) -> dict:
    """Three (or ``len(batches)``) updates from ``sd0``: the loss of each,
    each trainable leaf's first gradient, and each leaf's change over all
    of them. Leaves the loss does not reach get no gradient and do not
    move, as torch's Adam skips them."""
    sd = {k: v.detach().clone().float().to(device) for k, v in sd0.items()}
    names = [k for k in sd if trainable(k) and sd[k].is_floating_point()
             and not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))]
    m = {k: torch.zeros_like(sd[k]) for k in names}
    v = {k: torch.zeros_like(sd[k]) for k in names}
    start = {k: sd[k].clone() for k in names}
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start=1):
        b = {"obs": {k: torch.from_numpy(np.asarray(x)).to(device)
                     for k, x in batch["obs"].items()},
             "weights": torch.from_numpy(batch["weights"]).to(device),
             "not_done_masks": torch.from_numpy(
                 batch["not_done_masks"]).to(device)}
        params = {k: sd[k].requires_grad_(True) for k in names}
        loss_t = loss(sd, cfg, b, monitors)
        grads = torch.autograd.grad(loss_t, [params[k] for k in names],
                                    allow_unused=True)
        losses.append(float(loss_t.detach()))
        with torch.no_grad():
            if first_grad is None:
                first_grad = {k: (g.norm().item() if g is not None else None)
                              for k, g in zip(names, grads)}
            bc1 = 1 - ADAM["b1"] ** step
            bc2 = 1 - ADAM["b2"] ** step
            for k, g in zip(names, grads):
                if g is None:
                    continue
                m[k].mul_(ADAM["b1"]).add_(g, alpha=1 - ADAM["b1"])
                v[k].mul_(ADAM["b2"]).addcmul_(g, g, value=1 - ADAM["b2"])
                denom = (v[k].sqrt() / bc2 ** 0.5).add_(ADAM["eps"])
                sd[k] = sd[k].detach().addcdiv(m[k], denom, value=-lr / bc1)
        for k in names:
            sd[k] = sd[k].detach()
    change = {k: float((sd[k] - start[k]).norm()) for k in names}
    return {"losses": losses, "first_grad": first_grad, "change": change}
