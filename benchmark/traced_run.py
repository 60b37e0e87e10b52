"""One run of a cell with the port's tracer enabled over the whole
process, and the port's spans reduced over the measured window.

    python3 benchmark/traced_run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--spans FILE]

Runs ``benchmark/run.py`` as it is (its lines print as they do), then
prints one more line, ``program_spans: {...}`` (JSON), from the port's
tracer (``ws_mgmap_tpu_torch/utils/profiling.py``):

- ``window``: each span name that started in the measured window (its
  first ``--seconds`` from its start), with its count and its total and
  mean ms;
- with ``--trace 1``, ``sub_window``: the device's idle share of the
  profiled sub-window (``device_idle_pct``) and the part of it in which
  the host was inside the rollout engine's dispatch (``engine_idle_pct``:
  ``engine.act``, ``engine.update_map``) or inside the training update
  (``update_idle_pct``: ``train.update``).

``--spans FILE`` also writes the spans themselves and both windows'
bounds (Unix-epoch ns) as JSON.

The result line's end-to-end metrics, against ``run.py``'s on the same
seed, give the tracer's cost while it is on. The run only reads the
driver and the profiled sub-window through two wrappers installed in
this process; no file of the benchmark changes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402  (sets the environment)
from benchmark import harness, profiling  # noqa: E402

ENGINE = ("engine.act", "engine.update_map")
UPDATE = ("train.update",)


def started_in(spans, start_ns: int, end_ns: int) -> list:
    """The spans (name, thread, start_ns, end_ns) that start in
    [start_ns, end_ns)."""
    return [s for s in spans if start_ns <= s[2] < end_ns]


def by_name(spans) -> dict:
    out: dict = {}
    for name, _, s, e in spans:
        got = out.setdefault(name, {"count": 0, "total_ms": 0.0})
        got["count"] += 1
        got["total_ms"] += (e - s) / 1e6
    for got in out.values():
        got["mean_ms"] = got["total_ms"] / got["count"]
    return out


def union(intervals) -> list[list[float]]:
    """Sorted, disjoint [start, end] covering ``intervals``."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_inside_s(intervals_ns, kernels) -> float:
    """Seconds of the union of ``intervals_ns`` [(start_ns, end_ns)] in
    which no device operation of ``kernels`` [(name, start_us, end_us)]
    runs."""
    inside = union((s / 1e3, e / 1e3) for s, e in intervals_ns)
    busy = union((s, e) for _, s, e in kernels)
    total = sum(e - s for s, e in inside)
    i = j = 0
    while i < len(inside) and j < len(busy):
        s = max(inside[i][0], busy[j][0])
        e = min(inside[i][1], busy[j][1])
        if e > s:
            total -= e - s
        if inside[i][1] < busy[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6


def reduce(spans, window: tuple[int, int], sub=None) -> dict:
    """The ``program_spans`` line: ``window`` is the measured window's
    (start_ns, end_ns); ``sub`` the profiled sub-window's (start_ns,
    end_ns, trace), where ``trace`` has ``kernels``, ``window_s`` and
    ``busy_s()`` (:class:`profiling.Trace`)."""
    out = {"window_s": (window[1] - window[0]) / 1e9,
           "window": by_name(started_in(spans, *window))}
    if sub is not None:
        start, end, trace = sub
        inside = started_in(spans, start, end)
        got = {"seconds": trace.window_s,
               "device_idle_pct": 100.0 * (1 - trace.busy_s()
                                           / trace.window_s),
               "spans": by_name(inside)}
        for key, names in (("engine_idle_pct", ENGINE),
                           ("update_idle_pct", UPDATE)):
            mine = [(s, e) for n, _, s, e in inside if n in names]
            if mine and trace.kernels:
                got[key] = 100.0 * idle_inside_s(mine, trace.kernels) \
                    / trace.window_s
        out["sub_window"] = got
    return out


def main(argv=None) -> None:
    from ws_mgmap_tpu_torch.utils import profiling as tracer

    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--spans")
    opts, argv = own.parse_known_args(argv)
    args = bench_run.parse(argv)
    workload = harness.load_json("workloads", args.workload)
    driver = harness.import_file("drivers", workload["driver"])
    seen: dict = {}
    run_driver, run_profiled = driver.run, profiling.profiled

    def traced_driver(ctx, keep=False):
        seen["ctx"] = ctx
        seen["outcome"] = run_driver(ctx, keep)
        return seen["outcome"]

    def traced_profiled(*a, **k):
        start = time.time_ns()
        trace = run_profiled(*a, **k)
        seen["sub"] = (start, time.time_ns(), trace)
        return trace

    driver.run, profiling.profiled = traced_driver, traced_profiled
    tracer.enable()
    try:
        bench_run.main(argv)
    finally:
        tracer.disable()
        driver.run, profiling.profiled = run_driver, run_profiled
    spans = tracer.snapshot()
    ctx = seen["ctx"]
    start = int((ctx.t_start + seen["outcome"].metrics["setup_s"]) * 1e9)
    window = (start, start + int(ctx.seconds * 1e9))
    line = reduce(spans, window, seen.get("sub"))
    if opts.spans:
        sub = seen.get("sub")
        Path(opts.spans).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.spans).write_text(json.dumps({
            "window": window, "sub_window": sub[:2] if sub else None,
            "spans": spans}))
    print("program_spans: " + json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
