"""The harness: every file ``BENCHMARK.json`` names is found by its name
and an unknown one is refused; ``BENCHMARK.json`` keeps the contract's
shape; the import checks catch the JAX stack and the JAX package, and
not the port; the per-layer readers read a record and return nothing
where there is nothing to read."""
from __future__ import annotations

import ast
import re
import types

import pytest

from benchmark import harness

BENCH = harness.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_named_file_is_found():
    for c in BENCH["configs"]:
        assert harness.find("configs", c["name"]).as_posix().endswith(c["file"])
    for w in BENCH["workloads"]:
        wl = harness.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["why"] == w["why"]
        harness.import_file("drivers", wl["driver"])
    for m in BENCH["per_layer"]:
        assert callable(harness.import_file("layer_metrics", m["name"]).read)


@pytest.mark.parametrize("kind,name", [
    ("configs", "nope"), ("workloads", "fp32_rollout_b6"),
    ("drivers", "serve"), ("layer_metrics", "mfu_pct.serve"),
    ("workloads", "../BENCHMARK"), ("nonsense", "x")])
def test_unknown_names_refused(kind, name):
    with pytest.raises(harness.UnknownName):
        harness.find(kind, name)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = set()
    for name, w in cells.items():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reported = [m["name"] for m in BENCH["end_to_end"]
                    if harness.applies(m, name)]
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"] if harness.applies(m, name)]
        assert layer
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m.get("workloads", cells):
            assert harness.applies(e2e[m["moves"]], cell)
    names = ([c["name"] for c in BENCH["configs"]] + list(cells)
             + list(e2e) + [m["name"] for m in BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)


def test_forbidden_modules_caught_by_whole_top_level_name():
    assert harness.forbidden_loaded({"jax.numpy": 1}) == ["jax"]
    assert harness.forbidden_loaded({"jaxlib": 1, "flax.linen": 1}) == [
        "flax", "jaxlib"]
    assert harness.forbidden_loaded({"ws_mgmap_tpu.models": 1}) == [
        "ws_mgmap_tpu"]
    assert harness.forbidden_loaded({"ws_mgmap_tpu_torch.models": 1,
                                     "jaxtyping": 1, "torch": 1}) == []


def test_reference_holds_nothing_of_the_program():
    assert harness.reference_imports() == []
    ok = types.ModuleType("benchmark.reference.x")
    ok.torch_fn = len
    bad = types.ModuleType("benchmark.reference.y")
    bad.engine = type("RolloutEngine", (), {"__module__":
                                            "ws_mgmap_tpu_torch.train.rollout"})
    assert harness.reference_holds_program({"benchmark.reference.x": ok}) == []
    assert harness.reference_holds_program(
        {"benchmark.reference.y": bad}) == ["benchmark.reference.y.engine"]


def test_no_benchmark_file_imports_jax():
    for path in harness.BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".", 1)[0]
                assert top not in ("jax", "jaxlib", "flax", "ws_mgmap_tpu"), \
                    f"{path}: {m}"
                if "reference" in path.parts:
                    assert top != "ws_mgmap_tpu_torch", f"{path}: {m}"


class FakeTrace:
    def __init__(self, kernels, by_label, window_s, units):
        self.kernels, self.by_label = kernels, by_label
        self.window_s, self.units = window_s, units

    def busy_s(self):
        return sum(e - s for _, s, e in self.kernels) / 1e6


def record(driver: str, empty: bool):
    cfg = harness.load_json("configs", "wsmgmap_bf16")
    wl = harness.load_json("workloads", "bf16_rollout_b5" if driver ==
                           "rollout" else "fp32_train_n8")
    if empty:
        trace = FakeTrace([], {}, 1.0, {"cycles": 4, "updates": 2})
        return harness.Record({}, {}, {"flops": 0.0, "seconds": 1.0}, trace,
                              cfg, wl)
    kernels = [("conv3x3_wgmma_kernel", 0.0, 500.0),
               ("splat_max_kernel", 600.0, 700.0),
               ("Memcpy HtoD", 800.0, 900.0)]
    trace = FakeTrace(kernels, {"bench:unet": 2e-3, "bench:mapping": 1e-3,
                                "bench:conv_site": 5e-3,
                                "bench:upload": 0.1, "bench:map_modules": 0.2},
                      0.01, {"cycles": 4, "updates": 2})
    counters = {"splat": {"n_valid": 10000, "frames": 60, "pixels": 50176}}
    spans = {"batch_obs": [0.002, 0.004], "loader_wait": [0.01, 0.03]}
    window = {"flops": 1e12, "seconds": 2.0}
    return harness.Record(spans, counters, window, trace, cfg, wl)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_readers(metric):
    driver = "rollout" if metric.endswith(".rollout") else "train"
    read = harness.import_file("layer_metrics", metric).read
    assert read(record(driver, empty=True)) is None
    value = read(record(driver, empty=False))
    assert value is not None and value > 0
    unit = next(m["unit"] for m in BENCH["per_layer"] if m["name"] == metric)
    if unit == "%":
        assert value <= 100.0


def test_run_refuses_an_unknown_cell(capsys):
    from benchmark import run
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
    assert e.value.code == 2 and capsys.readouterr().out == ""


def test_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch

    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "fp32_rollout_b5", "--seed", str(2 ** 31 + 1),
                  "--seconds", "1"])
    assert e.value.code == 2 and capsys.readouterr().out == ""
