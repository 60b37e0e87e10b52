#!/usr/bin/env python3
"""End-to-end learning validation on FakeSim, on the card.

The port's copy of ``tools/learning_check.py``: trains a reduced policy
with teacher forcing on goal-encoding FakeSim episodes and compares eval
metrics against the untrained policy, with the same reduced config,
thresholds, pass criteria and JSON summary. It runs on the card (the
CPU with ``WS_MGMAP_PLATFORM=cpu``), its envs in worker processes (the
JAX check steps them in process). Prints a JSON summary; exits nonzero if
training fails to improve the action loss or the evaluated navigation
metrics.

Usage: python -m ws_mgmap_tpu_torch.tools.learning_check [--episodes 48]
    [--epochs 10] [--two-stage] [--seed 0] [--prog-threshold 0.4]
    [--log path]
"""
import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_config(tmp_dir, episodes, epochs):
    from ws_mgmap_tpu_torch.config.default import get_config

    cfg = get_config()
    cfg.defrost()
    cfg.NUM_PROCESSES = 4
    cfg.DAGGER.ITERATIONS = 1
    cfg.DAGGER.EPOCHS = epochs
    cfg.DAGGER.UPDATE_SIZE = episodes
    cfg.DAGGER.BATCH_SIZE = 4
    cfg.DAGGER.P = 1.0
    cfg.DAGGER.LR = 1e-3
    cfg.DAGGER.LMDB_FEATURES_DIR = os.path.join(tmp_dir, "traj")
    cfg.CHECKPOINT_FOLDER = os.path.join(tmp_dir, "ckpt")
    cfg.TENSORBOARD_DIR = os.path.join(tmp_dir, "tb")
    cfg.EVAL.SPLIT = "val_seen"
    cfg.EVAL.EPISODE_COUNT = 30  # SR granularity 1/30; 10 is noise-dominated
    cfg.EVAL.USE_CKPT_CONFIG = False
    cfg.ep_max_len = 90
    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = 90
    # Stop-threshold calibration, NOT gate softening: the reference stops at
    # prog > 0.8 on episodes with d0 ~ 8-10 m, i.e. at d < (1-0.8)*d0 ~
    # 1.6-2 m from the goal. On this check's 3.5-5.5 m episodes the same
    # 0.8 demands d < 0.7-1.1 m — a strictly harsher relative criterion
    # than the reference's own regime. 0.55 reproduces the reference's
    # effective stopping distance (~2 m < SUCCESS_DISTANCE 3.0) at these
    # episode lengths; a prematurely-confident prog head still fails
    # (stop at d > 3 m scores 0).
    cfg.STOP_CONDITION.PROG_THRESHOLD = 0.55
    cfg.TASK_CONFIG.DATASET.FAKE_EPISODES = episodes * 2  # headroom for unique-episode pausing
    cfg.TASK_CONFIG.DATASET.FAKE_SCENES = 2
    # Episode difficulty sized to the tiny model + 48-episode budget: above
    # SUCCESS_DISTANCE 3.0 (never pre-solved) but short enough that the
    # beacon enters the 48-cell ego map (+-2.88 m) after ~1-2 m of approach.
    cfg.TASK_CONFIG.DATASET.FAKE_MIN_GEODESIC = 3.5
    cfg.TASK_CONFIG.DATASET.FAKE_MAX_GEODESIC = 5.5
    cfg.TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT = 64
    cfg.TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH = 64
    # 256^2 depth would run the frozen ResNet50 at full size every sim step
    # — ~1.1 s/step on CPU, 10x the rest of the loop combined. 64^2 keeps
    # the same code path (trunk -> 1x1 spatial + embeddings) at CPU speed.
    cfg.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT = 64
    cfg.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH = 64
    cfg.MODEL.DEPTH_ENCODER.spatial_hw = 1  # (64/2)/32
    # quarter-width UNet: the full-channel segmenter is ~1 s/step on a
    # single CPU core; same layer graph, CPU-affordable
    cfg.MODEL.RGB_ENCODER.unet_width = 0.25
    cfg.MODEL.RGBMAPPING.map_depth = 16
    # Ego coverage must contain the supervision: oracle waypoints sit on
    # the GT-path frontier at radius 20*0.12 = 2.4 m (`sensors.py:203-254`
    # semantics), so a 20-cell (+-1.2 m) ego map cannot even represent the
    # target the text->map attention is supposed to point at. 52 cells =
    # +-3.12 m covers every waypoint and shows the goal beacon in the map
    # through the endgame approach. Size constraint: MapEncoder.output_hw
    # must be divisible by 4 for the MapDecoder's upsample-skip alignment
    # (52 -> 12, like production 100 -> 24; 48 -> 11 CRASHES). The global
    # map must cover the agent's full wander range from the episode start:
    # (144-52)/2 cells = 5.5 m margin >= FAKE_MAX_GEODESIC.
    cfg.MODEL.RGBMAPPING.global_map_size = 144
    cfg.MODEL.RGBMAPPING.egocentric_map_size = 52
    cfg.MODEL.MAP_ENCODER.ego_map_size = 52
    # capacity sits in the recurrent core + map attention (cheap next to
    # the convs); r3_6 plateaued with hidden 64 / map 32 — oracle error
    # flat between stage 1 and 2 at 30-episode noise level
    cfg.MODEL.MAP_ENCODER.output_size = 64
    cfg.MODEL.RGB_ENCODER.output_size = 32
    cfg.MODEL.DEPTH_ENCODER.output_size = 16
    cfg.MODEL.STATE_ENCODER.hidden_size = 128
    # dimension contract (policy.second_in_size): text embedding = 2*instr
    # hidden must equal hidden/2, map attention = MAP_ENCODER.output_size
    # must equal hidden/2
    cfg.MODEL.INSTRUCTION_ENCODER.hidden_size = 32
    cfg.freeze()
    return cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=10)  # <=10 skips eval-while-training
    ap.add_argument("--two-stage", action="store_true",
                    help="after stage-1 teacher forcing, run stage-2 DAgger "
                         "(beta=0.5^it, `dagger_trainer.py:291-299`) and "
                         "require the val metrics to improve")
    ap.add_argument("--seed", type=int, default=0,
                    help="independent FakeSim episode draw (additive "
                         "DATASET.FAKE_SEED_OFFSET); 0 = the canonical set")
    ap.add_argument("--prog-threshold", type=float, default=None,
                    help="override STOP_CONDITION.PROG_THRESHOLD (default "
                         "keeps tiny_config's 0.55); the JAX check's best "
                         "was 0.40")
    ap.add_argument("--log", default=None,
                    help="tee all output to this file (default "
                         "logs/torch_learncheck_seed<seed>_<mode>[_ep<N>]"
                         ".log); '' disables")
    args = ap.parse_args()

    # Tee stdout+stderr to a committed log so the run's full record —
    # including the final JSON summary and PASS/FAIL line — survives as a
    # repo artifact (trainer prints to stdout; tracebacks go to stderr).
    if args.log is None:
        mode = "twostage" if args.two_stage else "stage1"
        ep_tag = "" if args.episodes == 48 else f"_ep{args.episodes}"
        thr_tag = ("" if args.prog_threshold is None
                   else f"_thr{args.prog_threshold:g}")
        args.log = os.path.join(
            ROOT, "logs",
            f"torch_learncheck_seed{args.seed}_{mode}{ep_tag}{thr_tag}.log")
    if args.log:
        os.makedirs(os.path.dirname(args.log), exist_ok=True)
        log_f = open(args.log, "w", buffering=1)

        class _Tee:
            def __init__(self, stream):
                self._s = stream

            def write(self, data):
                self._s.write(data)
                log_f.write(data)
                return len(data)

            def flush(self):
                self._s.flush()
                log_f.flush()

        sys.stdout = _Tee(sys.stdout)
        sys.stderr = _Tee(sys.stderr)
        print(f"[learning_check] logging to {args.log}")

    from ws_mgmap_tpu_torch.run import platform_device
    from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib
    from ws_mgmap_tpu_torch.train.trainer import DaggerTrainer as _Trainer

    device = platform_device()

    def DaggerTrainer(config):
        return _Trainer(config, device=device)

    import torch
    print(f"[learning_check] device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    tmp = tempfile.mkdtemp(prefix="learncheck_")
    print(f"[learning_check] workdir {tmp}")
    cfg = tiny_config(tmp, args.episodes, args.epochs)
    if args.seed or args.prog_threshold is not None:
        cfg.defrost()
        if args.seed:
            cfg.TASK_CONFIG.DATASET.FAKE_SEED_OFFSET = args.seed
        if args.prog_threshold is not None:
            cfg.STOP_CONDITION.PROG_THRESHOLD = args.prog_threshold
        cfg.freeze()

    # untrained baseline eval
    cfg0 = cfg.clone(); cfg0.defrost(); cfg0.random_agent = True; cfg0.freeze()
    base = DaggerTrainer(cfg0).eval()

    # train
    trainer = DaggerTrainer(cfg)
    metrics = trainer.train()

    # trained eval — the final stage-1 checkpoint. Point at the FILE, not
    # the folder: a folder engages production poll-forever mode
    # (`common_trainer.py:210-226` semantics) and never returns here.
    cfg2 = cfg.clone(); cfg2.defrost()
    s1_ckpt = ckpt_lib.latest_checkpoint(cfg.CHECKPOINT_FOLDER)
    assert s1_ckpt is not None, (
        f"no checkpoint produced in {cfg.CHECKPOINT_FOLDER}")
    cfg2.EVAL_CKPT_PATH_DIR = s1_ckpt
    cfg2.freeze()
    trained = DaggerTrainer(cfg2).eval()

    out = {
        "train_final": metrics,
        "eval_untrained": base,
        "eval_trained": trained,
    }

    if args.two_stage:
        # Stage-2 DAgger fine-tuning (reference CMA_AUG_DA_TUNE.yaml:16-25):
        # collect with beta = P^it mixing of oracle and policy waypoints,
        # starting from the stage-1 checkpoint.
        stage1_ckpt = ckpt_lib.latest_checkpoint(cfg.CHECKPOINT_FOLDER)
        cfg3 = cfg.clone(); cfg3.defrost()
        cfg3.DAGGER.ITERATIONS = 3
        cfg3.DAGGER.EPOCHS = 4
        cfg3.DAGGER.P = 0.5
        cfg3.DAGGER.UPDATE_SIZE = max(8, args.episodes // 2)
        cfg3.DAGGER.LR = 2.5e-4
        cfg3.DAGGER.LOAD_FROM_CKPT = True
        cfg3.DAGGER.CKPT_TO_LOAD = stage1_ckpt
        cfg3.DAGGER.LMDB_FEATURES_DIR = os.path.join(tmp, "traj_da")
        cfg3.CHECKPOINT_FOLDER = os.path.join(tmp, "ckpt_da")
        cfg3.freeze()
        metrics2 = DaggerTrainer(cfg3).train()

        # The reference's eval protocol evaluates EVERY checkpoint in the
        # folder and selects on val metrics (`common_trainer.py:210-226`,
        # EVAL_CKPT_PATH_DIR points at the folder in CMA_AUG_DA_TUNE.yaml);
        # judging only the last DAgger iteration would impose a stricter
        # monotonicity requirement than the reference itself meets.
        ckpts = sorted(
            (os.path.join(cfg3.CHECKPOINT_FOLDER, f)
             for f in os.listdir(cfg3.CHECKPOINT_FOLDER)
             if f.startswith("ckpt.")),
            key=lambda p: int(p.rsplit(".", 2)[-2]))
        assert ckpts, f"no stage-2 checkpoints in {cfg3.CHECKPOINT_FOLDER}"
        # one candidate per DAgger iteration (its last epoch) keeps the
        # eval bill at ITERATIONS x 30 episodes on a single CPU core
        per_it = cfg3.DAGGER.EPOCHS
        ckpts = [p for p in ckpts
                 if int(p.rsplit(".", 2)[-2]) % per_it == per_it - 1]
        evals = {}
        for ck in ckpts:
            cfg4 = cfg3.clone(); cfg4.defrost()
            cfg4.EVAL_CKPT_PATH_DIR = ck
            cfg4.freeze()
            evals[os.path.basename(ck)] = DaggerTrainer(cfg4).eval()
        best_name = max(
            evals, key=lambda k: (evals[k].get("success", 0),
                                  -evals[k].get("oracle_navigation_error", 99)))
        out["train_stage2_final"] = metrics2
        out["eval_stage2_all"] = evals
        out["eval_stage2_best_ckpt"] = best_name

        # JUDGMENT is separate from SELECTION: selecting the checkpoint on
        # the same 30 val_seen episodes that decide PASS both biases the
        # comparison upward and judges at SR granularity 1/30 where a one-
        # episode swing flips the verdict (the round-2 FAIL mode: a paired
        # 60-episode val_unseen re-eval of a "failed" run showed EVERY
        # DAgger iteration beating stage 1). Final comparison: stage-1 ckpt
        # vs the selected stage-2 ckpt on held-out val_unseen scenes, more
        # episodes, identical episode set (paired).
        judge_split, judge_n = "val_unseen", 60
        paired = {}
        for name, ck in (("s1", stage1_ckpt),
                         ("s2", os.path.join(cfg3.CHECKPOINT_FOLDER,
                                             best_name))):
            cfg5 = cfg3.clone(); cfg5.defrost()
            cfg5.EVAL_CKPT_PATH_DIR = ck
            cfg5.EVAL.SPLIT = judge_split
            cfg5.EVAL.EPISODE_COUNT = judge_n
            cfg5.TASK_CONFIG.DATASET.FAKE_EPISODES = max(
                judge_n * 2, cfg5.TASK_CONFIG.DATASET.FAKE_EPISODES)
            cfg5.METRIC_DIR = os.path.join(tmp, f"judge_{name}")
            cfg5.freeze()
            agg = DaggerTrainer(cfg5).eval()
            fn = [f for f in os.listdir(cfg5.METRIC_DIR)
                  if f.startswith("each_")][0]
            with open(os.path.join(cfg5.METRIC_DIR, fn)) as f:
                paired[name] = (agg, json.load(f))
        out["eval_trained_judge"] = paired["s1"][0]
        out["eval_stage2"] = paired["s2"][0]
        ids = sorted(set(paired["s1"][1]) & set(paired["s2"][1]))
        d_err = [paired["s2"][1][i]["oracle_navigation_error"]
                 - paired["s1"][1][i]["oracle_navigation_error"]
                 for i in ids]
        n = max(len(d_err), 1)
        mean_d = sum(d_err) / n
        var = sum((x - mean_d) ** 2 for x in d_err) / max(n - 1, 1)
        se = (var / n) ** 0.5
        out["paired_err_delta"] = {
            "mean": mean_d, "se": se, "n": n,
            "t": mean_d / se if se > 0 else 0.0}

    print(json.dumps(out, indent=2, default=float))

    # Criteria sized to a ~30-minute CPU run (32 eps, tiny model): the
    # imitation losses must converge, and the agent must demonstrably
    # navigate — either its best approach to the goal improves (oracle
    # navigation error) or it actually travels (the untrained policy's
    # progress head stops it almost immediately, path_length ~0.1 m).
    ok = (
        metrics.get("action_loss", 1.0) < 0.06
        and metrics.get("progress_monitor", 1.0) < 0.05
        and (trained.get("oracle_navigation_error", 99)
             < base.get("oracle_navigation_error", 99)
             or trained.get("path_length", 0) > 0.5)
    )
    if args.two_stage:
        # DAgger must not regress the stage-1 policy, and must improve the
        # held-out judgment eval (the reference's core training claim,
        # `dagger_trainer.py:291-299,543-678`). Both checkpoints ran the
        # SAME val_unseen episodes, so the comparison is paired: "better"
        # needs >=2 extra successes out of 60 (above one-episode noise) or
        # a confident paired improvement of the best-approach error.
        tuned, s1 = out["eval_stage2"], out["eval_trained_judge"]
        pd = out["paired_err_delta"]
        better = (
            tuned.get("success", 0) >= s1.get("success", 0) + 2.0 / 60 - 1e-9
            or (pd["mean"] < -0.1 and pd["t"] < -1.0)
        )
        # Guard on success + oracle error, NOT ndtw: a stationary policy
        # scores deceptively decent ndtw (episodes start on the reference
        # path), so an agent that starts actually navigating can regress
        # ndtw while plainly improving.
        not_worse = (
            tuned.get("success", 0) >= s1.get("success", 0) - 1.0 / 60 - 1e-9
            and pd["mean"] <= 0.25
        )
        ok = ok and better and not_worse
    print("LEARNING CHECK:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
