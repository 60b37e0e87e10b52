#!/usr/bin/env python3
"""Stage-1 quality sweep: train stage-1 teacher forcing ONCE per data
budget, then judge-eval the checkpoint on held-out val_unseen at several
stop thresholds, isolating the two suspected SR levers (data budget, stop
calibration) without retraining per point.

The port's copy of ``tools/sweep_stage1.py``.

Usage:
  python -m ws_mgmap_tpu_torch.tools.sweep_stage1 --seed 0 --episodes 48 \\
      --epochs 10 --thresholds 0.55,0.7,0.8 [--judge-n 60] [--workdir DIR]
      [--in-process]
"""
import argparse
import json
import os
import tempfile

from ws_mgmap_tpu_torch.tools import learning_check as lc

REPORTED = ("success", "distance_to_goal", "oracle_navigation_error",
            "oracle_success", "steps_taken", "path_length")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--episodes", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--thresholds", default="0.55,0.7,0.8")
    ap.add_argument("--judge-n", type=int, default=60)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--workdir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--in-process", action="store_true",
                    help="step the envs in process (the JAX tool does)")
    args = ap.parse_args()

    from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib

    device, make = lc.trainer_factory(not args.in_process)
    lc.print_device(device)
    tmp = args.workdir or tempfile.mkdtemp(
        prefix=f"sweep_s1_{args.seed}_{args.episodes}_")
    print(f"[sweep_stage1] workdir {tmp}")
    cfg = lc.apply_overrides(lc.tiny_config(tmp, args.episodes, args.epochs),
                             args.seed, None)
    if args.lr is not None:
        cfg.defrost()
        cfg.DAGGER.LR = args.lr
        cfg.freeze()

    metrics = make(cfg).train()
    print(f"[sweep_stage1] train final: {json.dumps(metrics, default=float)}")
    ckpt = ckpt_lib.latest_checkpoint(cfg.CHECKPOINT_FOLDER)
    assert ckpt

    rows = []
    for thr in [float(t) for t in args.thresholds.split(",")]:
        agg = make(lc.eval_config(cfg, ckpt,
                                  os.path.join(tmp, f"judge_thr{thr}"),
                                  n=args.judge_n, threshold=thr)).eval()
        rows.append((thr, agg))
        print(f"[sweep_stage1] thr={thr:.2f} "
              + " ".join(f"{k}={agg.get(k, float('nan')):.3f}"
                         for k in REPORTED), flush=True)

    best = max(rows, key=lambda r: (r[1].get("success", 0),
                                    -r[1].get("oracle_navigation_error", 99)))
    print(json.dumps({
        "seed": args.seed, "episodes": args.episodes, "epochs": args.epochs,
        "ckpt": ckpt,
        "best_threshold": best[0],
        "best": best[1],
        "all": {f"{t:.2f}": a for t, a in rows},
    }, indent=2, default=float))


if __name__ == "__main__":
    main()
