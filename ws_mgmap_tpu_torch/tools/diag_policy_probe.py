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


def probe(cfg, engine, envs, episodes):
    """Roll ``episodes`` episodes out with ``engine`` under the eval
    protocol (24-step look-around, a decision every ``step_num`` steps);
    returns the per-decision errors, the first env's early decisions and
    the episodes' final measures."""
    n0 = envs.num_envs
    engine.reset_state(n0)
    observations = envs.reset()
    batch = engine.batch_obs(observations)
    masks = np.zeros((n0, 1), np.float32)
    stats = {}
    count_step = 0
    actions = np.zeros((envs.num_envs, 2), np.float32)
    wp_err, prog_err, recs, cos_sims = [], [], [], []

    while envs.num_envs > 0 and len(stats) < episodes:
        current = envs.current_episodes()
        if count_step % cfg.step_num == 0 and count_step >= 24:
            out = engine.act(batch, masks)
            actions = out.action.cpu().numpy()
            pred_wp = np.tanh(actions)
            oracle_wp = np.stack([np.asarray(o["waypoint"], np.float32)[:2]
                                  for o in observations])
            oracle_prog = np.asarray(
                [float(np.asarray(o["progress"]).reshape(-1)[0])
                 for o in observations])
            pred_prog = engine.prog[:, 0]
            for i in range(envs.num_envs):
                wp_err.append(float(np.linalg.norm(pred_wp[i] - oracle_wp[i])))
                no = np.linalg.norm(oracle_wp[i])
                npr = np.linalg.norm(pred_wp[i])
                if no > 1e-3 and npr > 1e-3:
                    cos_sims.append(float(
                        np.dot(pred_wp[i], oracle_wp[i]) / (no * npr)))
                prog_err.append(float(pred_prog[i] - oracle_prog[i]))
                if count_step < 40 and i == 0:
                    recs.append({
                        "step": count_step,
                        "pred_wp": [round(float(x), 3) for x in pred_wp[i]],
                        "oracle_wp": [round(float(x), 3)
                                      for x in oracle_wp[i]],
                        "pred_prog": round(float(pred_prog[i]), 3),
                        "oracle_prog": round(float(oracle_prog[i]), 3)})
        else:
            engine.update_map(batch, masks)
        if count_step < 24:
            actions = np.stack([np.asarray(o["waypoint"], np.float32)[:2]
                                for o in observations])
        prog = engine.prog
        outputs = envs.step([
            {"action": actions[e],
             "prog": float(prog[e, 0]) if count_step >= 24 else -1,
             "epidsode_reset_flag": count_step == 0}
            for e in range(envs.num_envs)])
        observations = [o[0] for o in outputs]
        dones = [o[2] for o in outputs]
        infos = [o[3] for o in outputs]
        count_step += 1
        masks = np.array([[0.0] if d else [1.0] for d in dones], np.float32)
        for i in range(envs.num_envs):
            if dones[i]:
                stats[current[i].episode_id] = infos[i]
        if all(dones):
            envs.resume_all()
            observations = envs.reset()
            engine.reset_state(envs.num_envs)
            masks = np.zeros((envs.num_envs, 1), np.float32)
            count_step = 0
            actions = np.zeros((envs.num_envs, 2), np.float32)
        batch = engine.batch_obs(observations)
        nxt = envs.current_episodes()
        to_pause = [i for i in range(envs.num_envs)
                    if nxt[i].episode_id in stats]
        if to_pause:
            keep = [i for i in range(envs.num_envs) if i not in to_pause]
            for i in reversed(to_pause):
                envs.pause_at(i)
            engine.keep(keep)
            observations = [observations[i] for i in keep]
            masks = masks[keep]
            actions = actions[keep]
            batch = engine.batch_obs(observations) if keep else batch
            if envs.num_envs == 0:
                break
    return wp_err, prog_err, cos_sims, recs, stats


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
