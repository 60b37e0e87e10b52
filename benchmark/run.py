"""The benchmark of the PyTorch/CUDA port (``ws_mgmap_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card(s) it asks for: the
cell's file ``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``) and its driver
(``benchmark/drivers/<driver>.py``), which sets up, warms up, measures
``--seconds`` and checks the timed path's outputs against the plain
reference. With ``--trace 0`` the result carries the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, each read by
``benchmark/layer_metrics/<metric>.py`` from a traced run. The last line
of standard output is the result as JSON; the numbers that decide
``correct`` are also the last lines of standard error. Exits 2 without a
result when there is no card, too few cards, or a forbidden module was
loaded.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parent.parent
# every cache of the program inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def device_info(torch, chips: int, outcome) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(outcome.memory_peak_bytes)}


def main(argv=None) -> None:
    args = parse(argv)
    t_start = min(harness.process_start(), T_IMPORT)
    try:
        workload = harness.load_json("workloads", args.workload)
        cfg = harness.load_json("configs", workload["config"])
        driver = harness.import_file("drivers", workload["driver"])
        bench = harness.benchmark_json()
    except harness.UnknownName as e:
        fail(str(e))
    import torch

    chips = workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " available")
    tmp = Path(tempfile.mkdtemp(prefix="wsmgmap_bench_"))
    ctx = harness.Ctx(name=args.workload, workload=workload, cfg=cfg,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      tmp=tmp, t_start=t_start)
    try:
        outcome = driver.run(ctx)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    wanted = harness.cell_metrics(bench, args.workload, ctx.trace)
    device = device_info(torch, chips, outcome)
    extra = {}
    if ctx.trace:
        metrics = harness.read_layer_metrics(bench, args.workload,
                                             outcome.record)
        trace = outcome.record.trace
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        extra["breakdown"] = trace.breakdown()
    else:
        metrics = {m["name"]: {"value": float(outcome.metrics[m["name"]]),
                               "unit": m["unit"]} for m in wanted}
    bad = harness.forbidden_loaded() + harness.reference_holds_program() \
        + harness.reference_imports()
    if bad:
        fail(f"forbidden modules loaded or imported: {bad}")
    line = harness.result_line(outcome, metrics, device)
    checks = line.pop("checks")
    line.update(extra)
    line["checks"] = checks
    print("set-up phases (s since start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in ctx.marks.items()), file=sys.stderr)
    if ctx.trace:
        print(f"traced: {outcome.record.trace.linked:.4f} of the device "
              "operations attributed to their launch", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
