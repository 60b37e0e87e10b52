#!/usr/bin/env python3
"""Finish an interrupted two-stage learning check: run BOTH judge evals.

The port's copy of ``tools/judge_finish.py``. ``resume_judge`` covers a
cut between the two final judge evals. This tool covers the earlier cut
point: stage-2 training finished (its checkpoints in ``ckpt_da/``) but
the selection evals and the judges had not run. It runs the paired
60-episode val_unseen judge evals (the stage-1 checkpoint against a
stage-2 checkpoint the caller chooses), computes the verdict with
``learning_check.verdict``, and appends a marked section to the log.

The stage-2 checkpoint is passed explicitly (``--best-ckpt``): when the
30-episode selection evals did not run, select on the 8-episode
in-training evals already in the log and say so. Selection only decides
which stage-2 candidate is judged; the judgment (60 held-out val_unseen
episodes, the same set for both) is unchanged.

Usage:
  python -m ws_mgmap_tpu_torch.tools.judge_finish --tmp WORKDIR --seed 7 \\
      --episodes 192 --prog-threshold 0.4 --best-ckpt ckpt.7.pth \\
      --log logs/torch_learncheck_seed7_twostage_ep192_thr0.4.log
"""
import argparse
import os

from ws_mgmap_tpu_torch.tools import learning_check as lc
from ws_mgmap_tpu_torch.tools.resume_judge import (add_common_args, finish,
                                                   judge, logged_stage1)


def main():
    ap = argparse.ArgumentParser()
    add_common_args(ap, 192)
    args = ap.parse_args()
    base, trained, metrics, _ = logged_stage1(args.log)
    lc.tee_to(args.log, "a")
    print(f"\n[judge_finish] finishing interrupted run in {args.tmp}: paired "
          f"judge evals (stage-1 ckpt vs {args.best_ckpt}) on val_unseen x60")
    print(f"[judge_finish] parsed from log: base_onav="
          f"{base['oracle_navigation_error']:.3f} "
          f"s1_action_loss={metrics['action_loss']:.4f} "
          f"s1_val_seen_success={trained['success']:.3f}")

    from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib

    device, make = lc.trainer_factory(not args.in_process)
    lc.print_device(device)
    cfg = lc.apply_overrides(lc.tiny_config(args.tmp, args.episodes,
                                            args.epochs),
                             args.seed, args.prog_threshold)
    s1_ckpt = ckpt_lib.latest_checkpoint(os.path.join(args.tmp, "ckpt"))
    s1_judge = judge(make, cfg, s1_ckpt, args.tmp, "s1")
    s2_judge = judge(make, cfg, os.path.join(args.tmp, "ckpt_da",
                                             args.best_ckpt),
                     args.tmp, "s2")
    finish({
        "finished_from": args.tmp,
        "train_final": metrics,
        "eval_untrained": base,
        "eval_trained": trained,
        "eval_stage2_best_ckpt": args.best_ckpt,
        "eval_trained_judge": s1_judge,
        "eval_stage2": s2_judge,
    }, args.tmp)


if __name__ == "__main__":
    main()
