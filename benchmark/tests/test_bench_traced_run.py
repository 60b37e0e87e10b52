"""``benchmark/traced_run.py``: the port's spans reduced over the measured
window and the profiled sub-window (known spans and device intervals
give known values), and a run's wiring: the tracer is on for the run and
off after it, the window starts where the driver's does, and the
sub-window is the one the driver profiled."""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from benchmark import harness, profiling, traced_run
from ws_mgmap_tpu_torch.utils import profiling as tracer

MS = 1_000_000                   # ns
T0 = 1_700_000_000_000_000_000   # an epoch time in ns


def kernel(name, start_ms, end_ms):
    return (name, (T0 + start_ms * MS) / 1e3, (T0 + end_ms * MS) / 1e3)


def span(name, start_ms, end_ms, tid=7):
    return (name, tid, T0 + int(start_ms * MS), T0 + int(end_ms * MS))


class FakeTrace:
    def __init__(self, kernels, window_s):
        self.kernels, self.window_s = kernels, window_s

    busy_s = profiling.Trace.busy_s


# a 100 ms sub-window from T0; the device runs 0-10, 20-30 and 50-90 ms
KERNELS = [kernel("a", 0, 10), kernel("b", 5, 10), kernel("c", 20, 30),
           kernel("d", 50, 90)]
SPANS = [span("engine.act", -50, -40),          # before both windows
         span("engine.act", 2, 25), span("engine.encode_text", 3, 9),
         span("engine.update_map", 30, 45), span("engine.update_map", 44, 60),
         span("train.update", 8, 40),
         span("replay.read", 60, 360, tid=8),
         span("engine.act", 150, 160)]           # past the sub-window


@pytest.mark.parametrize("case", ["window", "sub_window", "no_kernels"])
def test_reduce(case):
    kernels = [] if case == "no_kernels" else KERNELS
    sub = None if case == "window" else (T0, T0 + 100 * MS,
                                         FakeTrace(kernels, 0.1))
    out = traced_run.reduce(SPANS, (T0, T0 + 200 * MS), sub)
    assert out["window_s"] == pytest.approx(0.2)
    win = out["window"]
    assert win["engine.act"]["count"] == 2
    assert win["engine.act"]["total_ms"] == pytest.approx(33.0)
    assert win["engine.update_map"]["mean_ms"] == pytest.approx(15.5)
    assert win["replay.read"] == pytest.approx(
        {"count": 1, "total_ms": 300.0, "mean_ms": 300.0})
    if case == "window":
        assert "sub_window" not in out
        return
    got = out["sub_window"]
    assert got["spans"]["engine.act"]["count"] == 1
    assert got["seconds"] == 0.1
    if case == "no_kernels":
        assert got["device_idle_pct"] == pytest.approx(100.0)
        assert "engine_idle_pct" not in got and "update_idle_pct" not in got
        return
    assert got["device_idle_pct"] == pytest.approx(40.0)
    # the engine's spans cover 2-25 and 30-60 ms; the device runs 2-10,
    # 20-25 and 50-60 of that: idle 30 ms of 100 (epoch microseconds as
    # floats resolve to about 0.25 us)
    assert got["engine_idle_pct"] == pytest.approx(30.0, abs=1e-3)
    # 8-40 ms: busy 8-10 and 20-30, idle 20 ms
    assert got["update_idle_pct"] == pytest.approx(20.0, abs=1e-3)


def test_idle_inside():
    ks = [("k", 0.0, 10.0), ("k", 5.0, 12.0), ("k", 20.0, 30.0)]   # us
    assert traced_run.idle_inside_s([(0, 40_000)], ks) == pytest.approx(
        18e-6)
    assert traced_run.idle_inside_s([(2_000, 4_000), (3_000, 15_000),
                                     (25_000, 26_000)], ks) == \
        pytest.approx(3e-6)
    assert traced_run.idle_inside_s([(12_000, 20_000)], ks) == \
        pytest.approx(8e-6)
    assert traced_run.idle_inside_s([], ks) == 0.0


@pytest.mark.parametrize("trace", [0, 1])
def test_run_wiring(trace, monkeypatch, tmp_path, capsys):
    """A stand-in driver opens spans in set-up, in the window and in a
    profiled sub-window; ``run.main`` is replaced by what it does with
    the driver (the card's run is out of reach here)."""
    def sub_window():
        with tracer.span("engine.update_map"):
            pass

    def driver_run(ctx, keep=False):
        assert tracer.span("probe") is not tracer.span("probe")   # on
        with tracer.span("engine.act"):                           # set-up
            time.sleep(0.002)
        setup_s = time.time() - ctx.t_start
        with tracer.span("engine.act"):
            time.sleep(0.002)
        if ctx.trace:
            profiling.profiled(sub_window, set(), {})
        return harness.Outcome({"setup_s": setup_s}, [], 1, 0, 0)

    driver = SimpleNamespace(run=driver_run)
    monkeypatch.setattr(harness, "import_file", lambda kind, name: driver)

    def fake_main(argv):
        args = traced_run.bench_run.parse(argv)
        ctx = SimpleNamespace(t_start=time.time(), seconds=args.seconds,
                              trace=bool(args.trace))
        harness.import_file("drivers", "rollout").run(ctx)

    monkeypatch.setattr(traced_run.bench_run, "main", fake_main)
    profiled = profiling.profiled
    tracer.snapshot()
    out_file = tmp_path / "spans.json"
    traced_run.main(["--workload", "bf16_rollout_b5", "--seed", "3",
                     "--seconds", "30", "--trace", str(trace),
                     "--spans", str(out_file)])
    assert tracer.span("probe") is tracer.span("probe")            # off
    assert driver.run is driver_run
    assert profiling.profiled is profiled
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("program_spans: ")
    got = json.loads(line[len("program_spans: "):])
    assert got["window_s"] == pytest.approx(30.0)
    assert got["window"]["engine.act"]["count"] == 1
    dumped = json.loads(out_file.read_text())
    assert len(dumped["spans"]) == 2 + trace
    if trace:
        sub = got["sub_window"]["spans"]
        assert list(sub) == ["engine.update_map"]
        assert sub["engine.update_map"]["count"] == 1
        assert dumped["sub_window"][0] <= dumped["spans"][-1][2]
    else:
        assert "sub_window" not in got and dumped["sub_window"] is None
