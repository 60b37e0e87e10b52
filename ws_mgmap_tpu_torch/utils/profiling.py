"""The port's tracer and its per-loop step timers.

Usage:
    from ws_mgmap_tpu_torch.utils import profiling

    @profiling.span("engine.act")            # a decorator ...
    def act(...): ...
    with profiling.span("replay.read"):      # ... or a context manager
        ...
    profiling.enable()
    ...
    spans = profiling.snapshot()  # [(name, thread native id, start_ns, end_ns)]

    timers = StepTimers()
    with timers.span("collect/act"):
        ...
    timers.summary()  # {name: {count, total_s, mean_ms, p50_ms, max_ms}}

A span records while tracing is enabled (:func:`enable`). Its times are
``time.time_ns()``: the Unix-epoch nanoseconds of ``torch.profiler``'s
events, so a span compares directly with the device intervals of a
profile taken beside it. Spans record from any thread (the replay
loader's producer among them). A span never opens a ``record_function``
range: the profiler would mirror it onto the device timeline as an event
of its own.

Tracing is off by default. Off, opening a span costs one flag check and
the name's shared no-op context: no clock read and no allocation.

A span around work the card runs asynchronously measures its host side
(the dispatch) unless the work ends inside the span in a copy to the
host (``.cpu()``), as the collector's timers do.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

Span = Tuple[str, int, int, int]   # (name, thread native id, start_ns, end_ns)

_enabled = False
_spans: List[Span] = []
_lock = threading.Lock()


def enable() -> None:
    """Record every span from now on, until :func:`disable`."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def snapshot() -> List[Span]:
    """The spans that ended since the last snapshot, in the order they
    ended; the tracer starts afresh."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def _traced(name: str, fn):
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        if not _enabled:
            return fn(*args, **kwargs)
        with _Recorder(name):
            return fn(*args, **kwargs)
    return traced


class _Span:
    """A named span, usable as a decorator."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        return _traced(self.name, fn)


class _Recorder(_Span):
    """A span that records: its start on entry, the whole span on exit."""
    __slots__ = ("start",)

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        # the id ``threading`` keeps: ``get_native_id`` makes a system call
        # on every use, which some hosts make cost several microseconds
        tid = threading.current_thread().native_id
        with _lock:
            _spans.append((self.name, tid, self.start, end))
        return False


class _Off(_Span):
    """A span's no-op, one per name, shared by every use of the name."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF: Dict[str, _Off] = {}


def span(name: str):
    """A span named ``name``: a context manager, and a decorator whose
    every call is a span (whether it records is decided at each call)."""
    if _enabled:
        return _Recorder(name)
    off = _OFF.get(name)
    return off if off is not None else _OFF.setdefault(name, _Off(name))


class StepTimers:
    """Per-stage wall-clock timers for the rollout and training loops;
    each stage is also a tracer span."""

    def __init__(self):
        self._records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self._records[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._records[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self._records.items():
            s = sorted(vals)
            out[name] = {
                "count": len(vals),
                "total_s": sum(vals),
                "mean_ms": 1e3 * sum(vals) / len(vals),
                "p50_ms": 1e3 * s[len(s) // 2],
                "max_ms": 1e3 * s[-1],
            }
        return out

    def report(self, log_fn=print) -> None:
        for name, stats in sorted(self.summary().items()):
            log_fn(f"[timer] {name}: n={stats['count']} "
                   f"mean={stats['mean_ms']:.2f}ms p50={stats['p50_ms']:.2f}ms "
                   f"total={stats['total_s']:.2f}s")

    def reset(self) -> None:
        self._records.clear()
