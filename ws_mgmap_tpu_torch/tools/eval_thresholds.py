#!/usr/bin/env python3
"""Evaluate an existing learning-check checkpoint at several stop
thresholds (STOP_CONDITION.PROG_THRESHOLD) on the held-out judge split.

The port's copy of ``tools/eval_thresholds.py``. It separates the two
stage-1 quality levers: navigation (does the agent get within
SUCCESS_DISTANCE at all: oracle_success) and stop calibration (does it
stop there: success), without retraining.

Usage:
  python -m ws_mgmap_tpu_torch.tools.eval_thresholds --tmp WORKDIR \\
      --ckpt ckpt/ckpt.9.pth --seed 7 --episodes 96 \\
      --thresholds 0.40,0.47,0.55,0.65 [--in-process]
"""
import argparse
import json
import os

from ws_mgmap_tpu_torch.tools import learning_check as lc

REPORTED = ("success", "spl", "oracle_success", "distance_to_goal",
            "oracle_navigation_error", "steps_taken", "path_length")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tmp", required=True)
    ap.add_argument("--ckpt", required=True, help="relative to --tmp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--episodes", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--thresholds", default="0.40,0.47,0.55,0.65")
    ap.add_argument("--split", default="val_unseen")
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--in-process", action="store_true",
                    help="step the envs in process (the JAX tool does)")
    args = ap.parse_args()

    device, make = lc.trainer_factory(not args.in_process)
    lc.print_device(device)
    cfg = lc.apply_overrides(lc.tiny_config(args.tmp, args.episodes,
                                            args.epochs), args.seed, None)
    rows = []
    for thr in [float(t) for t in args.thresholds.split(",")]:
        agg = make(lc.eval_config(
            cfg, os.path.join(args.tmp, args.ckpt),
            os.path.join(args.tmp, f"thr_{thr}"), args.split, args.n,
            thr)).eval()
        rows.append({"threshold": thr, **agg})
        print(f"[eval_thresholds] thr={thr:.2f} "
              + " ".join(f"{k}={agg.get(k, float('nan')):.3f}"
                         for k in REPORTED), flush=True)
    print(json.dumps(rows, default=float))


if __name__ == "__main__":
    main()
