"""The benchmark's general machinery: finding a cell's files by name,
the run context, the checks that every run makes (the card, the modules
loaded, the reference's imports) and the result line."""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ws_mgmap_tpu")
PROGRAM = "ws_mgmap_tpu_torch"
KINDS = {"configs": ".json", "workloads": ".json", "drivers": ".py",
         "layer_metrics": ".py"}


class UnknownName(LookupError):
    pass


def find(kind: str, name: str) -> Path:
    """``benchmark/<kind>/<name><ext>``; raises :class:`UnknownName`."""
    if kind not in KINDS:
        raise UnknownName(f"no kind {kind!r} of benchmark file")
    if not name or "/" in name or name.startswith("."):
        raise UnknownName(f"bad {kind} name {name!r}")
    path = BENCH / kind / (name + KINDS[kind])
    if not path.is_file():
        raise UnknownName(f"no {kind} file for {name!r} ({path.name})")
    return path


def load_json(kind: str, name: str) -> dict:
    return json.loads(find(kind, name).read_text())


def import_file(kind: str, name: str):
    path = find(kind, name)
    modname = f"benchmark.{kind}.{name.replace('.', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[modname] = module
    spec.loader.exec_module(module)
    return module


def benchmark_json(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The end-to-end metrics (``trace`` false) or the per-layer ones that
    this cell reports."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if applies(m, workload)]


# -- checks ------------------------------------------------------------------------
def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of loaded modules that are the JAX stack or the JAX
    package, compared whole (the port's name starts with the package's)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def reference_imports(ref_dir: Path = BENCH / "reference") -> list[str]:
    """Modules imported by the reference's sources whose top-level name is
    the program's or a forbidden one."""
    bad = []
    for path in sorted(ref_dir.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".", 1)[0] in FORBIDDEN + (PROGRAM,):
                    bad.append(f"{path.name}: {n}")
    return bad


def reference_holds_program(modules=None) -> list[str]:
    """Loaded reference modules that hold an object of the program."""
    mods = sys.modules if modules is None else modules
    bad = []
    for name, mod in list(mods.items()):
        if not name.startswith("benchmark.reference") or mod is None:
            continue
        for key, val in vars(mod).items():
            owner = getattr(val, "__module__", None) or getattr(
                val, "__name__", "")
            if isinstance(owner, str) and owner.split(".", 1)[0] in (
                    PROGRAM,) + FORBIDDEN:
                bad.append(f"{name}.{key}")
    return bad


def process_start() -> float:
    """The wall-clock time this process started (Linux: /proc)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


# -- a run -------------------------------------------------------------------------
@dataclasses.dataclass
class Ctx:
    """What a driver is given: the cell's files, the run's flags, the
    device and a scratch directory under the run's TMPDIR."""
    name: str
    workload: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmp: Path
    t_start: float
    marks: dict = dataclasses.field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Note the seconds since the process started at the end of a
        set-up phase (printed to standard error)."""
        self.marks[phase] = time.time() - self.t_start


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``, beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the end-to-end metrics' values (by name),
    the checks, the work attempted and failed, the device's memory peak,
    and in a traced run the record the per-layer readers read."""
    metrics: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    record: Any = None


@dataclasses.dataclass
class Record:
    """What a traced run keeps for the per-layer readers: host spans
    (name -> list of seconds), counters, the measured window's totals
    (``window``), the profiled sub-window (``trace``: a
    :class:`profiling.Trace`), and the cell's configuration and traffic."""
    spans: dict
    counters: dict
    window: dict
    trace: Any
    cfg: dict
    workload: dict


def read_layer_metrics(bench: dict, name: str, record: Record) -> dict:
    out = {}
    for m in cell_metrics(bench, name, trace=True):
        value = import_file("layer_metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(outcome: Outcome, metrics: dict, device: dict) -> dict:
    return {"correct": all(c.ok for c in outcome.checks) and bool(
                outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device,
            "checks": {c.name: {"value": c.value, "limit": c.limit}
                       for c in outcome.checks}}
