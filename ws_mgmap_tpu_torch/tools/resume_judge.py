#!/usr/bin/env python3
"""Resume an interrupted two-stage learning check at the judge phase.

The port's copy of ``tools/resume_judge.py``. ``learning_check
--two-stage`` ends with two paired 60-episode val_unseen judge evals
(stage-1 checkpoint against the selected stage-2 one). If the process
dies between them, what is needed to finish is still in its workdir and
log: the checkpoints, the stage-1 judge metrics (``judge_s1/each_*.json``)
and the evals already logged. This tool runs ONLY the missing stage-2
judge eval, computes the verdict with ``learning_check.verdict``, and
appends a marked section with the summary to the same log.

``parse_log`` reads the JAX package's logs and the port's alike (the
port's epoch line puts ``loss=`` first).

Usage:
  python -m ws_mgmap_tpu_torch.tools.resume_judge --tmp WORKDIR --seed 7 \\
      --episodes 96 --best-ckpt ckpt.7.pth \\
      --log logs/torch_learncheck_seed7_twostage_ep96.log [--in-process]
"""
import argparse
import json
import os
import re
import sys

from ws_mgmap_tpu_torch.tools import learning_check as lc

EVAL_RE = re.compile(r"\[trainer\] \[eval\] (\d+) episodes: (.*)")
EPOCH_RE = re.compile(
    r"\[trainer\] dagger_it (\d+) epoch (\d+): \d+ batches in \S+s (.*)")
LOADING_RE = re.compile(r"\[trainer\] evaluating (\S+)")


def parse_log(path):
    """The evals and epochs a check's log holds: ``(evals, epochs)``,
    each eval ``(episodes, metrics, path of the checkpoint loaded before
    it or None)``, each epoch ``(iteration, epoch, metrics)``."""
    evals, epochs = [], []
    pending_path = None
    with open(path) as f:
        for line in f:
            m = LOADING_RE.search(line)
            if m:
                pending_path = m.group(1)
                continue
            m = EVAL_RE.search(line)
            if m:
                metrics = {k: float(v) for k, v in
                           (kv.split("=") for kv in m.group(2).split(", "))}
                evals.append((int(m.group(1)), metrics, pending_path))
                pending_path = None
                continue
            m = EPOCH_RE.search(line)
            if m:
                metrics = {k: float(v) for k, v in
                           (kv.split("=") for kv in m.group(3).split())}
                epochs.append((int(m.group(1)), int(m.group(2)), metrics))
    return evals, epochs


def stage1_final(epochs):
    """The last epoch's metrics of stage 1: the first contiguous run of
    iteration-0 epochs (stage 2 numbers its iterations from 0 again)."""
    s1 = []
    for it, ep, m in epochs:
        if it == 0 and ep == len(s1):
            s1.append(m)
        elif s1 and it == 0 and ep == 0:
            break
    return s1[-1]


def logged_stage1(path):
    """(untrained eval, stage-1 eval, stage-1 final train metrics, the
    stage-1 judge eval or None) as the log records them."""
    evals, epochs = parse_log(path)
    base = next(m for n, m, p in evals if n == 30 and p is None)
    trained = next(m for n, m, p in evals
                   if n == 30 and p and "/ckpt/ckpt." in p)
    s1_judge = next((m for n, m, p in evals
                     if n == 60 and p and "/ckpt/ckpt." in p), None)
    return base, trained, stage1_final(epochs), s1_judge


def read_summary(path):
    """The last JSON summary of a check's log and its ``LEARNING CHECK:``
    verdict (True for PASS)."""
    lines = open(path).read().splitlines()
    end = max(i for i, l in enumerate(lines) if l.startswith("LEARNING CHECK:"))
    close = max(i for i in range(end) if lines[i] == "}")
    start = max(i for i in range(close) if lines[i] == "{")
    out = json.loads("\n".join(lines[start:close + 1]))
    return out, lines[end].split(":", 1)[1].strip() == "PASS"


def finish(out, workdir):
    """Add the paired statistics of the two judges' per-episode metrics
    in ``workdir`` to ``out``, print it and its verdict, and exit with
    it."""
    out["paired_err_delta"] = lc.paired_err_delta(
        lc.read_each(os.path.join(workdir, "judge_s1")),
        lc.read_each(os.path.join(workdir, "judge_s2")))
    print(json.dumps(out, indent=2, default=float))
    ok = lc.verdict(out, two_stage=True)
    print("LEARNING CHECK:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


def add_common_args(ap, episodes):
    ap.add_argument("--tmp", required=True, help="the check's workdir")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--episodes", type=int, default=episodes)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--best-ckpt", required=True,
                    help="the stage-2 checkpoint to judge (a file name in "
                         "ckpt_da/)")
    ap.add_argument("--log", required=True)
    ap.add_argument("--prog-threshold", type=float, default=None,
                    help="must match the interrupted run's --prog-threshold")
    ap.add_argument("--in-process", action="store_true",
                    help="step the envs in process (the JAX tool does)")


def judge(make, cfg, ckpt, workdir, name):
    """Run the judge eval of ``ckpt`` into ``workdir/judge_<name>``."""
    return make(lc.eval_config(cfg, ckpt, os.path.join(
        workdir, f"judge_{name}"))).eval()


def main():
    ap = argparse.ArgumentParser()
    add_common_args(ap, 96)
    args = ap.parse_args()
    base, trained, metrics, s1_judge = logged_stage1(args.log)
    lc.tee_to(args.log, "a")
    print(f"\n[resume_judge] resuming interrupted run in {args.tmp}: "
          f"stage-2 judge eval of {args.best_ckpt} on val_unseen x60")
    print(f"[resume_judge] parsed from log: base_onav="
          f"{base['oracle_navigation_error']:.3f} "
          f"s1_action_loss={metrics['action_loss']:.4f} "
          f"s1_judge_success={s1_judge['success']:.3f}")

    device, make = lc.trainer_factory(not args.in_process)
    lc.print_device(device)
    cfg = lc.stage2_config(lc.apply_overrides(
        lc.tiny_config(args.tmp, args.episodes, args.epochs),
        args.seed, args.prog_threshold), args.tmp, args.episodes, None)
    s2_judge = judge(make, cfg, os.path.join(args.tmp, "ckpt_da",
                                             args.best_ckpt),
                     args.tmp, "s2")
    finish({
        "resumed_from": args.tmp,
        "train_final": metrics,
        "eval_untrained": base,
        "eval_trained": trained,
        "eval_stage2_best_ckpt": args.best_ckpt,
        "eval_trained_judge": s1_judge,
        "eval_stage2": s2_judge,
    }, args.tmp)


if __name__ == "__main__":
    main()
