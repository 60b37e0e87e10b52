"""Tracing and step timing (port of ``ws_mgmap_tpu/utils/profiling.py``).

Usage:
    with trace_if("/tmp/traces", enabled=cfg.PROFILE):  # torch.profiler
        ...
    timers = StepTimers()
    with timers.span("collect/act"):
        ...
    timers.summary()  # {name: {count, total_s, mean_ms, p50_ms, max_ms}}

The timers read the host's wall clock, as in JAX. A span around work
the card runs asynchronously measures only its enqueue unless the work
ends inside the span in a copy to the host (``.cpu()``), as the
collector's spans do.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List


@contextlib.contextmanager
def trace_if(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """``torch.profiler`` over the block (host and, where there is a
    card, device activity), its trace written into ``log_dir`` for
    TensorBoard's profiler plugin or ``chrome://tracing``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimers:
    """Per-stage wall-clock timers for the rollout and training loops."""

    def __init__(self):
        self._records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
