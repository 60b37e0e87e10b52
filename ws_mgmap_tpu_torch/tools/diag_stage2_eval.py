#!/usr/bin/env python3
"""Diagnose the two-stage DAgger effect: paired held-out re-evaluation.

The port's copy of ``tools/diag_stage2_eval.py``. Given a learning-check
workdir (``ckpt/`` + ``ckpt_da/``), re-evaluate the stage-1 checkpoint
and each stage-2 iteration's checkpoint on a fresh split (val_unseen
scenes the selection never saw) with more episodes, and report paired
per-episode deltas. Separates "DAgger does not improve this testbed"
from "the 30-episode val_seen gate is noise".

Usage: python -m ws_mgmap_tpu_torch.tools.diag_stage2_eval WORKDIR
    [--episodes 60] [--split val_unseen] [--seed 0] [--in-process]
"""
import argparse
import json
import os

import numpy as np

from ws_mgmap_tpu_torch.tools import learning_check as lc


def paired_line(name, base, stats):
    """One ``[paired]`` report line: ``stats`` against ``base`` over their
    shared episodes."""
    ids = sorted(set(base) & set(stats))
    d_err = np.array([stats[i]["oracle_navigation_error"]
                      - base[i]["oracle_navigation_error"] for i in ids])
    d_succ = np.array([stats[i]["success"] - base[i]["success"]
                       for i in ids])
    se = d_err.std(ddof=1) / max(np.sqrt(len(ids)), 1)
    return (f"[paired] {name} vs s1 (n={len(ids)}): "
            f"mean_err_delta={d_err.mean():+.3f} (se {se:.3f}, "
            f"t={d_err.mean() / se if se else 0:+.2f}), "
            f"err wins/losses={int((d_err < -1e-9).sum())}/"
            f"{int((d_err > 1e-9).sum())}, "
            f"succ_delta={d_succ.mean():+.3f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--split", default="val_unseen")
    ap.add_argument("--seed", type=int, default=0,
                    help="the run's --seed (its FakeSim episode draw)")
    ap.add_argument("--in-process", action="store_true",
                    help="step the envs in process (the JAX tool does)")
    args = ap.parse_args()

    from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib

    device, make = lc.trainer_factory(not args.in_process)
    lc.print_device(device)
    cfg = lc.apply_overrides(lc.tiny_config(args.run_dir, 48, 10),
                             args.seed, None)
    candidates = {"s1": ckpt_lib.latest_checkpoint(
        os.path.join(args.run_dir, "ckpt"))}
    for p in lc.stage2_candidates(os.path.join(args.run_dir, "ckpt_da")):
        it = int(p.rsplit(".", 2)[-2]) // lc.STAGE2_EPOCHS
        candidates[f"s2_it{it}"] = p

    per_ep = {}
    for name, ck in candidates.items():
        metric_dir = os.path.join(args.run_dir, f"diag_metric_{name}")
        agg = make(lc.eval_config(cfg, ck, metric_dir, args.split,
                                  args.episodes)).eval()
        print(f"[diag] {name}: " + " ".join(
            f"{k}={v:.3f}" for k, v in sorted(agg.items())), flush=True)
        per_ep[name] = lc.read_each(metric_dir)

    for name, stats in per_ep.items():
        if name != "s1":
            print(paired_line(name, per_ep["s1"], stats), flush=True)
    print(json.dumps({"checkpoints": candidates}, indent=2))


if __name__ == "__main__":
    main()
