"""The readings that set a cell's limits, in one process on the card.

    python3 benchmark/controls.py --workload <cell> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...] [--faults <name> ...]

For each of ``--seeds``: a run of the cell's driver (set-up, a window of
``--seconds``, the comparison with the reference) and its numbers. For
each of ``--control-seeds``: the control, the reference in the precision
below the configuration's (TF32 for fp32 with TF32 off, fp8 for bf16) in
the program's place, on the same steps. For each fault of
``benchmark/faults.py`` named by ``--faults``: a run with the fault
planted under the timed path, on each control seed. One JSON line per
reading. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from benchmark import faults, harness  # noqa: E402


def control_precision(cfg: dict, driver: str) -> str:
    dtype = cfg["rollout_dtype"] if driver == "rollout" else cfg["train_dtype"]
    if dtype == "bf16":
        return "fp8"
    if dtype == "fp32" and not cfg["tf32"]:
        return "tf32"
    raise ValueError(f"no control below {dtype} (tf32 {cfg['tf32']})")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    args = p.parse_args(argv)
    workload = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", workload["config"])
    driver = harness.import_file("drivers", workload["driver"])
    planted = faults.ROLLOUT if workload["driver"] == "rollout" else faults.TRAIN
    dev = torch.device("cuda", 0)
    precision = control_precision(cfg, workload["driver"])

    def one(seed: int, keep: bool):
        tmp = Path(tempfile.mkdtemp(prefix="wsmgmap_ctl_"))
        try:
            ctx = harness.Ctx(args.workload, workload, cfg, seed,
                              args.seconds, False, dev, tmp, time.time())
            return ctx, driver.run(ctx, keep=keep)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def emit(**row):
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        ctx, out = one(seed, seed in args.control_seeds)
        emit(seed=seed, reading="program",
             checks={c.name: c.value for c in out.checks},
             metrics=out.metrics)
        if seed in args.control_seeds:
            emit(seed=seed, reading=f"control_{precision}",
                 checks=driver.control_gaps(ctx, out.kept, precision))
        del out
        torch.cuda.empty_cache()
    for name in args.faults:
        for seed in args.control_seeds:
            with planted[name]():
                _, out = one(seed, False)
            emit(seed=seed, reading=f"fault_{name}",
                 checks={c.name: c.value for c in out.checks})
            del out
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
