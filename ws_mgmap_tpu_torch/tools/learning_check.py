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
    [--log path] [--workdir DIR] [--pack OUT | --unpack IN]

``--workdir`` keeps the run's checkpoints, stores and judge metrics in
DIR (default: a new temporary directory) and records each finished
phase in ``DIR/progress.json``; a run over a DIR that holds one resumes:
it skips the phases recorded there (a cut stage-1 or stage-2 training
starts that stage again) and appends to the log. ``--pack OUT`` copies
what a resumed run reads (progress, judge metrics
and the checkpoints still to be evaluated) out of ``--workdir`` and
exits; each checkpoint keeps only the tensors that differ from the
seeded initial policy, about 7 MB of 40 at this config. ``--unpack IN``
puts such a copy back into ``--workdir`` (the initial policy's tensors
checked by a digest) and resumes. The verdict (``verdict``) and the
paired judge statistics (``paired_err_delta``) are shared with
``resume_judge`` and ``judge_finish``.
"""
import argparse
import hashlib
import json
import os
import sys
import shutil
import subprocess
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


def apply_overrides(cfg, seed, prog_threshold):
    """The run's episode draw and stop threshold (``--seed``,
    ``--prog-threshold``) over ``tiny_config``."""
    if seed or prog_threshold is not None:
        cfg.defrost()
        if seed:
            cfg.TASK_CONFIG.DATASET.FAKE_SEED_OFFSET = seed
        if prog_threshold is not None:
            cfg.STOP_CONDITION.PROG_THRESHOLD = prog_threshold
        cfg.freeze()
    return cfg


STAGE2_EPOCHS = 4


def stage2_config(cfg, tmp, episodes, stage1_ckpt):
    """Stage-2 DAgger fine-tuning (reference CMA_AUG_DA_TUNE.yaml:16-25):
    collect with beta = P^it mixing of oracle and policy waypoints,
    starting from the stage-1 checkpoint (None: the tree alone, as
    ``resume_judge`` rebuilds it)."""
    cfg3 = cfg.clone(); cfg3.defrost()
    cfg3.DAGGER.ITERATIONS = 3
    cfg3.DAGGER.EPOCHS = STAGE2_EPOCHS
    cfg3.DAGGER.P = 0.5
    cfg3.DAGGER.UPDATE_SIZE = max(8, episodes // 2)
    cfg3.DAGGER.LR = 2.5e-4
    if stage1_ckpt is not None:
        cfg3.DAGGER.LOAD_FROM_CKPT = True
        cfg3.DAGGER.CKPT_TO_LOAD = stage1_ckpt
    cfg3.DAGGER.LMDB_FEATURES_DIR = os.path.join(tmp, "traj_da")
    cfg3.CHECKPOINT_FOLDER = os.path.join(tmp, "ckpt_da")
    cfg3.freeze()
    return cfg3


JUDGE_SPLIT, JUDGE_N = "val_unseen", 60  # held out, the same set for all


def eval_config(cfg, ckpt, metric_dir, split=JUDGE_SPLIT, n=JUDGE_N,
                threshold=None):
    """``cfg`` evaluating ``ckpt`` on ``n`` episodes of ``split`` (the
    FakeSim split made large enough), its metrics into ``metric_dir``; by
    default the judge eval, 60 held-out val_unseen episodes, the same
    set for every checkpoint (paired)."""
    c = cfg.clone(); c.defrost()
    c.EVAL_CKPT_PATH_DIR = ckpt
    c.EVAL.SPLIT = split
    c.EVAL.EPISODE_COUNT = n
    c.TASK_CONFIG.DATASET.FAKE_EPISODES = max(
        n * 2, c.TASK_CONFIG.DATASET.FAKE_EPISODES)
    if threshold is not None:
        c.STOP_CONDITION.PROG_THRESHOLD = threshold
    c.METRIC_DIR = metric_dir
    c.freeze()
    return c


def read_each(metric_dir):
    """The per-episode metrics an eval wrote into ``metric_dir``."""
    fn = [f for f in os.listdir(metric_dir) if f.startswith("each_")][0]
    with open(os.path.join(metric_dir, fn)) as f:
        return json.load(f)


def paired_err_delta(s1_each, s2_each):
    """Mean, standard error, count and t of the per-episode oracle
    navigation error, stage 2 minus stage 1, over the shared episodes."""
    ids = sorted(set(s1_each) & set(s2_each))
    d_err = [s2_each[i]["oracle_navigation_error"]
             - s1_each[i]["oracle_navigation_error"] for i in ids]
    n = max(len(d_err), 1)
    mean_d = sum(d_err) / n
    var = sum((x - mean_d) ** 2 for x in d_err) / max(n - 1, 1)
    se = (var / n) ** 0.5
    return {"mean": mean_d, "se": se, "n": n,
            "t": mean_d / se if se > 0 else 0.0}


def verdict(out, two_stage):
    """PASS (True) or FAIL of a check's summary ``out``.

    Criteria sized to a ~30-minute CPU run (32 eps, tiny model): the
    imitation losses must converge, and the agent must demonstrably
    navigate — either its best approach to the goal improves (oracle
    navigation error) or it actually travels (the untrained policy's
    progress head stops it almost immediately, path_length ~0.1 m).

    Two-stage: DAgger must not regress the stage-1 policy, and must
    improve the held-out judgment eval (the reference's core training
    claim, `dagger_trainer.py:291-299,543-678`). Both checkpoints ran the
    SAME val_unseen episodes, so the comparison is paired: "better" needs
    >=2 extra successes out of 60 (above one-episode noise) or a
    confident paired improvement of the best-approach error. The guard is
    on success + oracle error, NOT ndtw: a stationary policy scores
    deceptively decent ndtw (episodes start on the reference path), so an
    agent that starts actually navigating can regress ndtw while plainly
    improving."""
    metrics = out["train_final"]
    trained, base = out["eval_trained"], out["eval_untrained"]
    ok = (
        metrics.get("action_loss", 1.0) < 0.06
        and metrics.get("progress_monitor", 1.0) < 0.05
        and (trained.get("oracle_navigation_error", 99)
             < base.get("oracle_navigation_error", 99)
             or trained.get("path_length", 0) > 0.5)
    )
    if not two_stage:
        return ok
    tuned, s1 = out["eval_stage2"], out["eval_trained_judge"]
    pd = out["paired_err_delta"]
    better = (
        tuned.get("success", 0) >= s1.get("success", 0) + 2.0 / 60 - 1e-9
        or (pd["mean"] < -0.1 and pd["t"] < -1.0)
    )
    not_worse = (
        tuned.get("success", 0) >= s1.get("success", 0) - 1.0 / 60 - 1e-9
        and pd["mean"] <= 0.25
    )
    return ok and better and not_worse


def card_line():
    """The card's name and power limit as nvidia-smi gives them, or None
    where there is no nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def tee_to(path, mode="w"):
    """Send stdout and stderr to ``path`` as well (a committed log holds
    the run's whole record: the trainer prints to stdout, tracebacks go
    to stderr)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    log_f = open(path, mode, buffering=1)

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


def trainer_factory(env_workers=True):
    """(device, make): ``make(config)`` builds a ``DaggerTrainer`` on the
    device ``WS_MGMAP_PLATFORM`` names (the card unless it is ``cpu``),
    its envs in worker processes or, with ``env_workers=False``, in
    process as the JAX study tools step them."""
    from ws_mgmap_tpu_torch.run import platform_device
    from ws_mgmap_tpu_torch.train.trainer import DaggerTrainer

    device = platform_device()

    def make(config):
        return DaggerTrainer(config, env_workers=env_workers, device=device)

    return device, make


def print_device(device):
    """Log the run's device and, on a card, its name and power limit."""
    import torch

    print(f"[learning_check] device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    if device.type == "cuda":
        print(f"[learning_check] card: {card_line()}")


class Progress:
    """The phases a run finished, in ``<workdir>/progress.json``."""

    def __init__(self, workdir):
        self.path = os.path.join(workdir, "progress.json")
        self.done = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.done = json.load(f)

    def record(self, key, value):
        self.done[key] = value
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.done, f, indent=1, default=float)
        os.replace(tmp, self.path)
        return value


def stage2_candidates(folder):
    """The stage-2 checkpoints the selection evals read: one per DAgger
    iteration (its last epoch), in index order."""
    names = sorted((f for f in os.listdir(folder) if f.startswith("ckpt.")),
                   key=lambda f: int(f.rsplit(".", 2)[-2]))
    return [os.path.join(folder, f) for f in names
            if int(f.rsplit(".", 2)[-2]) % STAGE2_EPOCHS
            == STAGE2_EPOCHS - 1]


def _initial_state(cfg):
    """The state_dict every trainer of ``cfg`` starts from (seeded)."""
    from ws_mgmap_tpu_torch.train.trainer import DaggerTrainer

    trainer = DaggerTrainer(cfg, env_workers=False, device="cpu")
    return trainer.init_policy().state_dict()


def _digest(state, keys):
    h = hashlib.sha256()
    for k in keys:
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def pack(workdir, out, cfg):
    """Copy what a resumed run reads out of ``workdir`` into ``out``."""
    import torch

    done = Progress(workdir).done
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(workdir, "progress.json"), out)
    for name in ("judge_s1", "judge_s2"):
        if os.path.isdir(os.path.join(workdir, name)):
            shutil.copytree(os.path.join(workdir, name),
                            os.path.join(out, name), dirs_exist_ok=True)
    ckpts = []
    if "stage1_ckpt" in done:
        ckpts.append(os.path.join("ckpt", done["stage1_ckpt"]))
    if "train_stage2_final" in done:
        ckpts += [os.path.relpath(p, workdir) for p in stage2_candidates(
            os.path.join(workdir, "ckpt_da"))]
    init = _initial_state(cfg)
    for rel in ckpts:
        blob = torch.load(os.path.join(workdir, rel), map_location="cpu",
                          weights_only=False)
        sd = blob["state_dict"]
        same = [k for k, v in sd.items()
                if k in init and torch.equal(v, init[k])]
        blob["state_dict"] = {k: v for k, v in sd.items() if k not in same}
        blob["from_initial"] = {"keys": same, "digest": _digest(init, same)}
        os.makedirs(os.path.dirname(os.path.join(out, rel)), exist_ok=True)
        torch.save(blob, os.path.join(out, rel))
        print(f"[learning_check] packed {rel}: {len(same)} of {len(sd)} "
              f"tensors from the initial policy")


def unpack(src, workdir, cfg):
    """Put ``pack``'s copy back into ``workdir``, checkpoints whole."""
    import torch

    os.makedirs(workdir, exist_ok=True)
    init = _initial_state(cfg)
    for root, _, files in os.walk(src):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), src)
            dst = os.path.join(workdir, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if not f.endswith(".pth"):
                shutil.copy(os.path.join(src, rel), dst)
                continue
            blob = torch.load(os.path.join(src, rel), map_location="cpu",
                              weights_only=False)
            info = blob.pop("from_initial")
            if _digest(init, info["keys"]) != info["digest"]:
                raise RuntimeError(
                    f"{rel}: this machine's initial policy differs from the "
                    "one the checkpoint was packed against")
            sd = {k: init[k] for k in info["keys"]}
            sd.update(blob["state_dict"])
            blob["state_dict"] = {k: sd[k] for k in init if k in sd}
            blob["state_dict"].update(
                {k: v for k, v in sd.items() if k not in init})
            torch.save(blob, dst)
            print(f"[learning_check] unpacked {rel}")


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
    ap.add_argument("--workdir", default=None,
                    help="keep the run's files here (default: a new "
                         "temporary directory)")
    ap.add_argument("--pack", default=None, metavar="OUT",
                    help="copy what a resumed run reads out of --workdir "
                         "into OUT, and exit")
    ap.add_argument("--unpack", default=None, metavar="IN",
                    help="put a --pack copy into --workdir, then resume")
    args = ap.parse_args()
    if (args.pack or args.unpack) and not args.workdir:
        ap.error("--pack and --unpack need --workdir")
    if args.pack:
        pack(args.workdir, args.pack, apply_overrides(
            tiny_config(os.path.abspath(args.workdir), args.episodes,
                        args.epochs), args.seed, args.prog_threshold))
        return
    resuming = bool(args.unpack) or bool(args.workdir) and os.path.exists(
        os.path.join(args.workdir, "progress.json"))

    if args.log is None:
        mode = "twostage" if args.two_stage else "stage1"
        ep_tag = "" if args.episodes == 48 else f"_ep{args.episodes}"
        thr_tag = ("" if args.prog_threshold is None
                   else f"_thr{args.prog_threshold:g}")
        args.log = os.path.join(
            ROOT, "logs",
            f"torch_learncheck_seed{args.seed}_{mode}{ep_tag}{thr_tag}.log")
    if args.log:
        tee_to(args.log, "a" if resuming else "w")
        print(f"[learning_check] logging to {args.log}")

    from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib

    device, DaggerTrainer = trainer_factory()
    print_device(device)
    if args.workdir:
        tmp = os.path.abspath(args.workdir)
        os.makedirs(tmp, exist_ok=True)
    else:
        tmp = tempfile.mkdtemp(prefix="learncheck_")
    cfg = apply_overrides(tiny_config(tmp, args.episodes, args.epochs),
                          args.seed, args.prog_threshold)
    if args.unpack:
        unpack(args.unpack, tmp, cfg)
    progress = Progress(tmp)
    print(f"[learning_check] workdir {tmp}"
          + (f" (resuming after: {', '.join(progress.done)})"
             if progress.done else ""))
    done = progress.done

    # untrained baseline eval
    if "eval_untrained" in done:
        base = done["eval_untrained"]
    else:
        cfg0 = cfg.clone(); cfg0.defrost(); cfg0.random_agent = True
        cfg0.freeze()
        base = progress.record("eval_untrained", DaggerTrainer(cfg0).eval())

    # train
    if "train_final" in done:
        metrics = done["train_final"]
        s1_ckpt = os.path.join(cfg.CHECKPOINT_FOLDER, done["stage1_ckpt"])
    else:
        for d in (cfg.CHECKPOINT_FOLDER, cfg.DAGGER.LMDB_FEATURES_DIR):
            shutil.rmtree(d, ignore_errors=True)
        metrics = DaggerTrainer(cfg).train()
        s1_ckpt = ckpt_lib.latest_checkpoint(cfg.CHECKPOINT_FOLDER)
        assert s1_ckpt is not None, (
            f"no checkpoint produced in {cfg.CHECKPOINT_FOLDER}")
        progress.record("stage1_ckpt", os.path.basename(s1_ckpt))
        progress.record("train_final", metrics)

    # trained eval — the final stage-1 checkpoint. Point at the FILE, not
    # the folder: a folder engages production poll-forever mode
    # (`common_trainer.py:210-226` semantics) and never returns here.
    if "eval_trained" in done:
        trained = done["eval_trained"]
    else:
        cfg2 = cfg.clone(); cfg2.defrost()
        cfg2.EVAL_CKPT_PATH_DIR = s1_ckpt
        cfg2.freeze()
        trained = progress.record("eval_trained", DaggerTrainer(cfg2).eval())

    out = {
        "train_final": metrics,
        "eval_untrained": base,
        "eval_trained": trained,
    }

    if args.two_stage:
        cfg3 = stage2_config(cfg, tmp, args.episodes, s1_ckpt)
        if "train_stage2_final" in done:
            metrics2 = done["train_stage2_final"]
        else:
            # a cut stage 2 starts again from the stage-1 checkpoint
            for d in (cfg3.CHECKPOINT_FOLDER, cfg3.DAGGER.LMDB_FEATURES_DIR):
                shutil.rmtree(d, ignore_errors=True)
            metrics2 = progress.record("train_stage2_final",
                                       DaggerTrainer(cfg3).train())

        # The reference's eval protocol evaluates EVERY checkpoint in the
        # folder and selects on val metrics (`common_trainer.py:210-226`,
        # EVAL_CKPT_PATH_DIR points at the folder in CMA_AUG_DA_TUNE.yaml);
        # judging only the last DAgger iteration would impose a stricter
        # monotonicity requirement than the reference itself meets.
        # one candidate per DAgger iteration (its last epoch) keeps the
        # eval bill at ITERATIONS x 30 episodes on a single CPU core
        ckpts = stage2_candidates(cfg3.CHECKPOINT_FOLDER)
        assert ckpts, f"no stage-2 checkpoints in {cfg3.CHECKPOINT_FOLDER}"
        evals = dict(done.get("eval_stage2_all", {}))
        for ck in ckpts:
            if os.path.basename(ck) in evals:
                continue
            cfg4 = cfg3.clone(); cfg4.defrost()
            cfg4.EVAL_CKPT_PATH_DIR = ck
            cfg4.freeze()
            evals[os.path.basename(ck)] = DaggerTrainer(cfg4).eval()
            progress.record("eval_stage2_all", evals)
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
        paired = {}
        for name, ck in (("s1", s1_ckpt),
                         ("s2", os.path.join(cfg3.CHECKPOINT_FOLDER,
                                             best_name))):
            key = f"judge_{name}"
            metric_dir = os.path.join(tmp, key)
            if key not in done:
                progress.record(key, DaggerTrainer(
                    eval_config(cfg3, ck, metric_dir)).eval())
            paired[name] = (done[key], read_each(metric_dir))
        out["eval_trained_judge"] = paired["s1"][0]
        out["eval_stage2"] = paired["s2"][0]
        out["paired_err_delta"] = paired_err_delta(paired["s1"][1],
                                                   paired["s2"][1])

    print(json.dumps(out, indent=2, default=float))
    ok = verdict(out, args.two_stage)
    print("LEARNING CHECK:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
