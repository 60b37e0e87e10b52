#!/usr/bin/env python3
"""CLI dress rehearsal on real-format data.

The port's copy of ``tools/cli_rehearsal.py``. It builds a miniature
R2R_VLNCE tree in the reference's exact file schemas
(``real_format_fixtures.py``: ``{split}.json.gz`` episodes +
``instruction_vocab``, ``embeddings.json.gz``, ``{split}_gt.json.gz``,
``map_data/<split>/ep_<id>.npy``) and drives the command line
(``python -m ws_mgmap_tpu_torch.run``) over it on FakeSim scenes:

    train (stage-1 teacher forcing)  -> checkpoints written
    train (stage-2 DAgger fine-tune) -> beta-mixed collection + checkpoints
    eval                             -> metric JSONs in the run dir
    inference                        -> predictions file

This holds the data layer, the config surgery (``refine_config``'s split
propagation, ``set_save_dir``'s run-dir layout), dotted-key overrides
and the CLI glue in one run. The JAX tool's YAML writes ``LR: 1e-3``,
which PyYAML reads as the string ``"1e-3"`` (YAML 1.1 floats need a
dot); the JAX package passes that string to its optimizer, whose first
update raises. The port's YAML writes ``LR: 0.001``, the value meant.

Runs on the card; ``WS_MGMAP_PLATFORM=cpu`` runs it on the CPU.

Usage: python -m ws_mgmap_tpu_torch.tools.cli_rehearsal [--workdir DIR]
    [--episodes 4] [--timeout 1800]
Exits 0 only if all four runs complete and write their artifacts.
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

from ws_mgmap_tpu_torch.tools.real_format_fixtures import (VOCAB,
                                                           build_fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPLITS = ("train", "val_seen", "val_unseen", "val_unseen_min")

# the JAX tool's reduced model, under MODEL:
TINY_MODEL = """  INSTRUCTION_ENCODER:
    vocab_size: {vocab}
    hidden_size: 16
    use_pretrained_embeddings: True
  RGB_ENCODER:
    output_size: 32
    unet_width: 0.25
  DEPTH_ENCODER:
    output_size: 16
    spatial_hw: 1
  MAP_ENCODER:
    output_size: 32
    ego_map_size: 20
  STATE_ENCODER:
    hidden_size: 64
  RGBMAPPING:
    map_depth: 16
    global_map_size: 48
    egocentric_map_size: 20
"""
# the reference's widths: only the vocabulary follows the data
FULL_MODEL = """  INSTRUCTION_ENCODER:
    vocab_size: {vocab}
    use_pretrained_embeddings: True
"""


def build_tree(root: str, n_eps: int) -> list:
    """Every split the rehearsal reads, under ``root``; returns the
    vocabulary."""
    for split in SPLITS:
        build_fixtures(root, split=split, n_eps=n_eps)
    return VOCAB


def rehearsal_yaml(episodes: int, vocab_size: int, tiny: bool = True,
                   iterations: int = 1, epochs: int = 2, p: float = 1.0
                   ) -> str:
    """The rehearsal's experiment YAML: 2 envs, ``iterations`` DAgger
    iterations of ``epochs`` epochs at beta ``p``, and the JAX tool's
    reduced model (``tiny``) or the reference's widths."""
    model = (TINY_MODEL if tiny else FULL_MODEL).format(vocab=vocab_size)
    return f"""BASE_TASK_CONFIG_PATH: ws_mgmap_tpu_torch/config/vlnce_task.yaml
NUM_PROCESSES: 2
EVAL:
  USE_CKPT_CONFIG: False
  SPLIT: val_seen
  EPISODE_COUNT: {episodes}
DAGGER:
  ITERATIONS: {iterations}
  EPOCHS: {epochs}
  UPDATE_SIZE: {episodes}
  BATCH_SIZE: 2
  P: {p}
  LR: 0.001
MODEL:
{model}"""


def data_opts(data: str, max_steps: int = 60, rgb: int = 64,
              depth: int = 64) -> list:
    """Dotted-key overrides (the reference's OPTS merge path) that point
    the config at the tree and cut the episodes and sensors."""
    return [
        "TASK_CONFIG.DATASET.DATA_PATH",
        os.path.join(data, "{split}.json.gz"),
        "TASK_CONFIG.TASK.NDTW.GT_PATH",
        os.path.join(data, "{split}_gt.json.gz"),
        "TASK_CONFIG.TASK.GT_SEMANTIC_MAP_SENSOR.DATA_DIR",
        os.path.join(data, "map_data", "{split}"),
        "MODEL.INSTRUCTION_ENCODER.embedding_file",
        os.path.join(data, "embeddings.json.gz"),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", str(max_steps),
        "ep_max_len", str(max_steps),
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", str(rgb),
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", str(rgb),
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", str(depth),
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", str(depth),
    ]


def _ckpts(model_dir: str) -> list:
    return sorted(glob.glob(os.path.join(model_dir, "run_train_base",
                                         "checkpoint", "ckpt.*.pth")),
                  key=lambda p: int(p.split(".")[-2]))


def rehearse(work: str, run, yaml_text: str, da_yaml_text: str,
             opts: list, log=print) -> dict:
    """The four runs in ``work``; ``run(run_type, yaml_path, model_dir,
    opts)`` runs one. Checks each run's artifacts and returns them:
    the stage-1 and stage-2 checkpoints, the eval metrics and the number
    of predicted trajectories."""
    yaml_path = os.path.join(work, "TINY_REAL.yaml")
    da_yaml = os.path.join(work, "TINY_REAL_DA_TUNE.yaml")
    for path, text in ((yaml_path, yaml_text), (da_yaml, da_yaml_text)):
        with open(path, "w") as f:
            f.write(text)

    # stage-1 teacher forcing
    model_dir = os.path.join(work, "exp")
    run("train", yaml_path, model_dir, opts)
    ckpts = _ckpts(model_dir)
    assert ckpts, "stage-1 produced no checkpoints"
    latest = ckpts[-1]
    log(f"[cli_rehearsal] stage-1 OK: {len(ckpts)} ckpts")

    # stage-2 DAgger fine-tune from the stage-1 checkpoint
    run("train", da_yaml, os.path.join(work, "exp_da"), opts + [
        "DAGGER.LOAD_FROM_CKPT", "True", "DAGGER.CKPT_TO_LOAD", latest])
    da_ckpts = _ckpts(os.path.join(work, "exp_da"))
    assert da_ckpts, "stage-2 produced no checkpoints"
    log(f"[cli_rehearsal] stage-2 OK: {len(da_ckpts)} ckpts")

    # eval
    eval_dir = os.path.join(work, "exp_eval")
    run("eval", yaml_path, eval_dir, opts + ["EVAL_CKPT_PATH_DIR", latest])
    metric_files = glob.glob(os.path.join(eval_dir, "run_eval_base",
                                          "metric", "stats_ckpt_*.json"))
    assert metric_files, "eval produced no metric JSON"
    with open(metric_files[0]) as f:
        metrics = json.load(f)
    assert "success" in metrics and "spl" in metrics, metrics
    log(f"[cli_rehearsal] eval OK: {metrics}")

    # inference
    pred_path = os.path.join(work, "predictions.json")
    run("inference", yaml_path, os.path.join(work, "exp_inf"), opts + [
        "INFERENCE.CKPT_PATH", latest, "INFERENCE.SPLIT", "val_unseen",
        "INFERENCE.PREDICTIONS_FILE", pred_path])
    with open(pred_path) as f:
        preds = json.load(f)
    assert len(preds) >= 1, "inference wrote no trajectories"
    log(f"[cli_rehearsal] inference OK: {len(preds)} trajectories")
    return {"stage1_ckpts": ckpts, "stage2_ckpts": da_ckpts,
            "metrics": metrics, "predictions": len(preds)}


def subprocess_runner(timeout: int):
    """``run`` for :func:`rehearse`: ``python -m ws_mgmap_tpu_torch.run``
    in a child process from the repo root, with this environment
    (``WS_MGMAP_PLATFORM`` included)."""
    def run(run_type, cfg_yaml, model_dir, opts):
        cmd = [sys.executable, "-m", "ws_mgmap_tpu_torch.run",
               "--run-type", run_type, "-c", cfg_yaml, "-e", model_dir] + opts
        print(f"[cli_rehearsal] $ {' '.join(cmd[1:9])} ... ({run_type})",
              flush=True)
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=REPO)
        if r.returncode != 0:
            print(r.stdout[-4000:])
            print(r.stderr[-4000:])
            raise SystemExit(f"{run_type} FAILED rc={r.returncode}")
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--episodes", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args()

    work = args.workdir or tempfile.mkdtemp(prefix="cli_rehearsal_")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(work, "R2R_VLNCE_v1-2_preprocessed")
    vocab = build_tree(data, args.episodes)
    rehearse(work, subprocess_runner(args.timeout),
             rehearsal_yaml(args.episodes, len(vocab)),
             rehearsal_yaml(args.episodes, len(vocab), iterations=2, p=0.5),
             data_opts(data), log=lambda m: print(m, flush=True))
    print("CLI REHEARSAL: PASS")


if __name__ == "__main__":
    main()
