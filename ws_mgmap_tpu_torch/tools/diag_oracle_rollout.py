#!/usr/bin/env python3
"""Diagnostic: the oracle's ceiling on the FakeSim learning-check task.

The port's copy of ``tools/diag_oracle_rollout.py``. Rolls out the exact
eval protocol (24-step look-around, a decision every ``step_num`` steps,
the GT follower toward the chosen waypoint) with actions from the
oracle waypoint sensor and the stop driven by the oracle progress
sensor: a policy that regresses its supervision targets perfectly. Its
success and oracle error are the ceiling ``learning_check`` can
approach; if THEY are low, the task or the check is miscalibrated, not
the trainer. No policy runs, so no device is needed. The env stops an
episode where the oracle progress passes ``STOP_CONDITION.PROG_THRESHOLD``
(``--prog-threshold``, the check's 0.55 by default); the JAX tool's
``--prog-th`` was never read, and the port has none.

Usage: python -m ws_mgmap_tpu_torch.tools.diag_oracle_rollout
    [--episodes 20] [--prog-threshold T] [--max-steps 90]
    [--stop-mode prog|geodesic] [--seed 0] [--split val_seen]
    [--in-process]
"""
import argparse
import json
import tempfile

import numpy as np

from ws_mgmap_tpu_torch.tools import learning_check as lc


def oracle_rollout(envs, episodes, stop_mode="prog"):
    """Roll ``episodes`` episodes out on the oracle sensors; returns each
    episode's final measures and a trace of its end."""
    observations = envs.reset()
    stats, trace = {}, []
    count_step = 0
    while envs.num_envs > 0 and len(stats) < episodes:
        current = envs.current_episodes()
        actions = np.stack([
            np.arctanh(np.clip(np.asarray(o["waypoint"], np.float32)[:2],
                               -0.999, 0.999))
            for o in observations])
        progs = [float(np.asarray(o["progress"]).reshape(-1)[0])
                 for o in observations]
        if stop_mode == "geodesic":
            send_prog = [-1.0] * envs.num_envs
        else:
            send_prog = [p if count_step >= 24 else -1 for p in progs]
        outputs = envs.step([
            {"action": actions[e], "prog": send_prog[e],
             "epidsode_reset_flag": count_step == 0}
            for e in range(envs.num_envs)])
        observations = [o[0] for o in outputs]
        dones = [o[2] for o in outputs]
        infos = [o[3] for o in outputs]
        count_step += 1
        for i in range(envs.num_envs):
            if dones[i]:
                stats[current[i].episode_id] = infos[i]
                trace.append({"ep": current[i].episode_id,
                              "steps": infos[i].get("steps_taken"),
                              "prog_at_done": progs[i]})
        if all(dones):
            envs.resume_all()
            observations = envs.reset()
            count_step = 0
        nxt = envs.current_episodes()
        to_pause = [i for i in range(envs.num_envs)
                    if nxt[i].episode_id in stats]
        if to_pause:
            keep = [i for i in range(envs.num_envs) if i not in to_pause]
            for i in reversed(to_pause):
                envs.pause_at(i)
            observations = [observations[i] for i in keep]
            if envs.num_envs == 0:
                break
    return stats, trace


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=20)
    ap.add_argument("--prog-threshold", type=float, default=None,
                    help="override STOP_CONDITION.PROG_THRESHOLD, as "
                    "learning_check --prog-threshold")
    ap.add_argument("--max-steps", type=int, default=90)
    ap.add_argument("--stop-mode", choices=["prog", "geodesic"],
                    default="prog",
                    help="prog: eval-style stop when oracle progress "
                    "exceeds the stop threshold; geodesic: collection-"
                    "style stop "
                    "(prog=-1, env stops at geodesic<0.5)")
    ap.add_argument("--seed", type=int, default=0,
                    help="independent FakeSim episode draw "
                    "(DATASET.FAKE_SEED_OFFSET), as learning_check --seed")
    ap.add_argument("--split", default="val_seen",
                    help="FakeSim split to roll out (e.g. val_unseen = the "
                    "learning-check judge split)")
    ap.add_argument("--in-process", action="store_true",
                    help="step the envs in process (the JAX tool does)")
    args = ap.parse_args()

    from ws_mgmap_tpu_torch.env.vector_env import construct_envs
    from ws_mgmap_tpu_torch.train.trainer import load_split

    cfg = lc.apply_overrides(
        lc.tiny_config(tempfile.mkdtemp(prefix="diag_oracle_"),
                       args.episodes, 1), args.seed, args.prog_threshold)
    cfg.defrost()
    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = args.max_steps
    cfg.ep_max_len = args.max_steps
    cfg.freeze()
    dataset, gt = load_split(cfg, args.split)
    envs = construct_envs(cfg, dataset, gt, auto_reset_done=False,
                          workers=not args.in_process)
    try:
        stats, trace = oracle_rollout(envs, args.episodes, args.stop_mode)
    finally:
        envs.close()

    agg = {}
    if stats:
        for k in next(iter(stats.values())):
            vals = [s[k] for s in stats.values() if np.isfinite(s[k])]
            agg[k] = float(np.mean(vals)) if vals else float("nan")
    print(json.dumps({"n": len(stats), "stop_mode": args.stop_mode,
                      "agg": agg, "trace": trace}, indent=2, default=float))


if __name__ == "__main__":
    main()
