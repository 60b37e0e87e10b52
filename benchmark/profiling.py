"""Labels around the program's modules, and the reduction of a
``torch.profiler`` trace to device time by label, busy and idle time,
launch counts and the longest idle gaps.

A label is a ``record_function`` range around a module's forward or a
function, installed on the engine's or the train state's own policy in a
traced run only. A kernel counts toward every label among the CPU ops
above the op that launched it; a kernel of the backward pass, whose op
has no label above it, counts toward the labels of the forward op with
the same autograd sequence number.
"""
from __future__ import annotations

import bisect
import functools
import time

import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

BACKWARD = "autograd::engine::evaluate_function"
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def labelled(fn, label: str):
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)
    wrapped.__wrapped_label__ = label
    return wrapped


def label_path(root, path: str, label: str) -> None:
    """Wrap ``root.<path>`` (a module's forward, or a function attribute
    of an object or a module) in a range named ``label``."""
    *parents, last = path.split(".")
    owner = root
    for p in parents:
        owner = getattr(owner, p)
    target = getattr(owner, last)
    if isinstance(target, torch.nn.Module):
        target.forward = labelled(target.forward, label)
    else:
        setattr(owner, last, labelled(target, label))


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


class Trace:
    """One profiled sub-window, reduced: ``kernels`` [(name, start_us,
    end_us)] of every device operation (kernels, copies, sets), the
    device seconds under each label (``by_label``), the share of device
    operations whose launch was found (``linked``), the wall seconds of
    the sub-window (``window_s``) and the units of work it held.

    ``backward=False``: a device operation counts toward each label whose
    range, on the launching thread, holds the time of its launch (the
    runtime or driver call with its correlation id). This finds kernels
    that the program launches through its own library (``ctypes``), which
    no PyTorch op encloses. ``backward=True``: the op tree of the
    profiler's events, a backward kernel going to the labels of the
    forward op with its autograd sequence number."""

    def __init__(self, prof, labels: set[str], window_s: float, units: dict,
                 backward: bool = False):
        self.window_s = window_s
        self.units = units
        raw = prof.profiler.kineto_results.events()
        dev = [e for e in raw if e.device_type() == CUDA
               and e.name() not in labels]
        self.kernels = sorted(((e.name(), e.start_ns() / 1e3,
                                e.end_ns() / 1e3) for e in dev),
                              key=lambda k: k[1])
        host = [e for e in raw if e.device_type() == CPU]
        if backward:
            self.by_label, self.linked = self._by_ops(prof.events(), labels)
        else:
            self.by_label, self.linked = self._by_launch(host, dev, labels)
        self._host = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                            for e in host if e.duration_ns() >= 100_000)

    @staticmethod
    def _by_launch(host, dev, labels: set[str]) -> tuple[dict, float]:
        ranges: dict = {}      # (thread, label) -> sorted [(start, end)]
        launch: dict = {}      # CUDA correlation id -> (thread, time)
        op_at: dict = {}       # op id -> (thread, time)
        for e in host:
            where = (e.start_thread_id(), e.start_ns())
            name = e.name()
            if name in labels:
                ranges.setdefault((where[0], name), []).append(
                    (e.start_ns(), e.end_ns()))
            if name.startswith(("cuda", "cu")):
                launch[e.correlation_id()] = where
            else:
                op_at[e.correlation_id()] = where
        for v in ranges.values():
            v.sort()
        starts = {k: [s for s, _ in v] for k, v in ranges.items()}
        out: dict[str, float] = {}
        found = 0
        for e in dev:
            where = launch.get(e.correlation_id()) or op_at.get(
                e.linked_correlation_id())
            if where is None:
                continue
            found += 1
            tid, t = where
            for label in labels:
                key = (tid, label)
                if key not in ranges:
                    continue
                i = bisect.bisect_right(starts[key], t) - 1
                if i >= 0 and ranges[key][i][1] >= t:
                    out[label] = out.get(label, 0.0) + e.duration_ns() / 1e9
        return out, found / max(len(dev), 1)

    @staticmethod
    def _by_ops(events, labels: set[str]) -> tuple[dict, float]:
        cpu = [e for e in events if e.device_type == CPU]
        seq_labels: dict[int, set[str]] = {}
        for e in sorted(cpu, key=lambda e: e.time_range.start):
            chain = list(_ancestors(e))
            if e.sequence_nr >= 0 and not any(p.name.startswith(BACKWARD)
                                              for p in chain):
                seq_labels[e.sequence_nr] = {p.name for p in chain
                                             if p.name in labels}
        out: dict[str, float] = {}
        linked = 0
        for e in cpu:
            if not e.kernels:
                continue
            chain = list(_ancestors(e))
            found = {p.name for p in chain if p.name in labels}
            if not found and any(p.name.startswith(BACKWARD) for p in chain):
                found = next((seq_labels[p.sequence_nr] for p in chain
                              if seq_labels.get(p.sequence_nr)), set())
            for k in e.kernels:
                linked += 1
                for label in found:
                    out[label] = out.get(label, 0.0) + k.duration / 1e6
        total = sum(1 for e in events if e.device_type == CUDA
                    and e.name not in labels)
        return out, linked / max(total, 1)

    def busy_s(self) -> float:
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.kernels:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, s, e in self.kernels:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest gaps between device operations, each named by the
        longest host op (of 0.1 ms or more) running at its midpoint."""
        gaps, last = [], None
        for _, s, e in self.kernels:
            if last is not None and s > last:
                gaps.append((s - last, last, s))
            last = e if last is None else max(last, e)
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:top]:
            mid = (s + e) / 2
            around = [(he - hs, n) for hs, he, n in self._host
                      if hs <= mid <= he]
            name = max(around)[1] if around else "host outside any op"
            out.append([name[:80], length / 1e6])
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:80], s] for n, s in ops],
                "idle_gaps": self.idle_gaps()}


def profiled(run, labels: set[str], units: dict, backward: bool = False
             ) -> Trace:
    """Run ``run()`` under the profiler (CPU and CUDA activities) and
    reduce what it recorded."""
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        window_s = time.perf_counter() - t0
    return Trace(prof, labels, window_s, units, backward)
