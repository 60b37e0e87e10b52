#!/usr/bin/env python3
"""Diagnostic: per-decision waypoint and progress error of a trained
checkpoint.

The port's copy of ``tools/diag_policy_probe.py``. Replays eval episodes
with the trained policy, logging at every decision step the predicted
waypoint against the oracle waypoint sensor and the predicted progress
against the oracle progress sensor: the direct measure of how well
stage-1 imitation transferred to rollout (the aggregate SR is
noise-dominated at learning-check scale).

Usage: python -m ws_mgmap_tpu_torch.tools.diag_policy_probe CKPT
    [--episodes 8] [--seed 0] [--split val_seen] [--prog-threshold T]
    [--in-process]
"""
import argparse
import json
import tempfile

import numpy as np

from ws_mgmap_tpu_torch.tools import learning_check as lc
from ws_mgmap_tpu_torch.train.evaluator import EvalObserver, rollout


class _Errors(EvalObserver):
    """Each decision's waypoint and progress errors against the oracle
    sensors of the observations it was made on, and the first row's
    decisions before step 40."""

    def __init__(self):
        self.wp_err, self.prog_err, self.recs, self.cos_sims = [], [], [], []

    def decided(self, out, observations, count_step):
        pred_wp = np.tanh(out.action.cpu().numpy())
        oracle_wp = np.stack([np.asarray(o["waypoint"], np.float32)[:2]
                              for o in observations])
        oracle_prog = np.asarray(
            [float(np.asarray(o["progress"]).reshape(-1)[0])
             for o in observations])
        pred_prog = out.prog.cpu().numpy()[:, 0]
        for i in range(len(observations)):
            self.wp_err.append(float(np.linalg.norm(pred_wp[i]
                                                    - oracle_wp[i])))
            no = np.linalg.norm(oracle_wp[i])
            npr = np.linalg.norm(pred_wp[i])
            if no > 1e-3 and npr > 1e-3:
                self.cos_sims.append(float(
                    np.dot(pred_wp[i], oracle_wp[i]) / (no * npr)))
            self.prog_err.append(float(pred_prog[i] - oracle_prog[i]))
            if count_step < 40 and i == 0:
                self.recs.append({
                    "step": count_step,
                    "pred_wp": [round(float(x), 3) for x in pred_wp[i]],
                    "oracle_wp": [round(float(x), 3) for x in oracle_wp[i]],
                    "pred_prog": round(float(pred_prog[i]), 3),
                    "oracle_prog": round(float(oracle_prog[i]), 3)})


def probe(cfg, engine, envs, episodes):
    """Roll ``episodes`` episodes out with ``engine`` under the eval loop
    (``train/evaluator.py::rollout``); returns the per-decision errors,
    the first env's early decisions and the episodes' final measures."""
    errors = _Errors()
    stats = rollout(cfg, engine, envs, episodes, errors)
    return (errors.wp_err, errors.prog_err, errors.cos_sims, errors.recs,
            stats)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="the FakeSim episode draw, as learning_check --seed")
    ap.add_argument("--split", default="val_seen")
    ap.add_argument("--prog-threshold", type=float, default=None,
                    help="the stop threshold the checkpoint's check used")
    ap.add_argument("--in-process", action="store_true",
                    help="step the envs in process (the JAX tool does)")
    args = ap.parse_args()

    from ws_mgmap_tpu_torch.env.vector_env import construct_envs
    from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine
    from ws_mgmap_tpu_torch.train.trainer import load_split

    device, make = lc.trainer_factory(not args.in_process)
    lc.print_device(device)
    cfg = lc.apply_overrides(
        lc.tiny_config(tempfile.mkdtemp(prefix="diag_probe_"),
                       args.episodes, 1), args.seed, args.prog_threshold)
    trainer = make(cfg)
    policy = trainer.init_policy()
    ckpt_lib.restore(policy, args.ckpt)
    dataset, gt = load_split(cfg, args.split)
    engine = RolloutEngine(policy, cfg.NUM_PROCESSES,
                           compute_dtype=trainer.rollout_dtype, device=device)
    envs = construct_envs(cfg, dataset, gt, auto_reset_done=False,
                          workers=not args.in_process)
    try:
        wp_err, prog_err, cos_sims, recs, stats = probe(
            cfg, engine, envs, args.episodes)
    finally:
        envs.close()

    agg = {}
    for k in next(iter(stats.values())):
        vals = [s[k] for s in stats.values() if np.isfinite(s[k])]
        agg[k] = round(float(np.mean(vals)), 3) if vals else None
    print(json.dumps({
        "n_eps": len(stats),
        "n_decisions": len(wp_err),
        "wp_l2_mean": round(float(np.mean(wp_err)), 4),
        "wp_l2_p50": round(float(np.median(wp_err)), 4),
        "wp_cos_mean": (round(float(np.mean(cos_sims)), 4)
                        if cos_sims else None),
        "prog_err_mean": round(float(np.mean(prog_err)), 4),
        "prog_err_std": round(float(np.std(prog_err)), 4),
        "agg": agg,
        "first_episode_trace": recs,
    }, indent=2))


if __name__ == "__main__":
    main()
