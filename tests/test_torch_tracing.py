"""The port's tracer (``ws_mgmap_tpu_torch/utils/profiling.py``): nothing
is recorded while tracing is off; on, each span carries its name, its
thread and Unix-epoch nanoseconds on the clock of ``torch.profiler``'s
events; the replay loader, the rollout engine and the training update
record their spans where the work runs; a profiler session alone does
not turn the tracer on; and no span shows up as an event of a
profile."""
from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from tests.torch_port_common import INSTR_LEN, port_config, raw_obs, tokens
from ws_mgmap_tpu_torch.data.trajstore import TrajStoreWriter, pack_record
from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.tools import synthetic
from ws_mgmap_tpu_torch.train import replay
from ws_mgmap_tpu_torch.train import step as step_mod
from ws_mgmap_tpu_torch.train.losses import MonitorConfig
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine
from ws_mgmap_tpu_torch.utils import profiling
from ws_mgmap_tpu_torch.utils.profiling import StepTimers


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.disable()
    profiling.snapshot()
    yield
    profiling.disable()
    profiling.snapshot()


def names(spans) -> list[str]:
    return [s[0] for s in spans]


@profiling.span("probe.decorated")
def decorated(x):
    return x + 1


def run_case() -> int:
    """Spans of every kind of use: as a context manager, as a decorator,
    from a second thread, through ``StepTimers``."""
    with profiling.span("probe.ctx"):
        pass
    assert decorated(1) == 2

    def in_thread():
        with profiling.span("probe.thread"):
            pass

    t = threading.Thread(target=in_thread)
    t.start()
    t.join()
    timers = StepTimers()
    with timers.span("probe.timer"):
        pass
    assert timers.summary()["probe.timer"]["count"] == 1
    return t.native_id


@pytest.mark.parametrize("case", ["off", "on", "on_then_off"])
def test_tracer_records_only_while_on(case):
    if case != "off":
        profiling.enable()
    other = run_case()
    if case == "on_then_off":
        profiling.disable()
        run_case()
    spans = profiling.snapshot()
    if case == "off":
        assert spans == []
        assert profiling.span("probe.ctx") is profiling.span("probe.ctx")
        return
    assert sorted(names(spans)) == sorted(
        ["probe.ctx", "probe.decorated", "probe.thread", "probe.timer"])
    me = threading.get_native_id()
    for name, tid, start, end in spans:
        assert tid == (other if name == "probe.thread" else me), name
        assert 0 < start <= end
    assert profiling.snapshot() == []


def test_no_span_lost_between_threads():
    """More threads than cores record spans while the main thread takes
    snapshots, with a short switch interval: every span lands in exactly
    one snapshot."""
    threads, each = (os.cpu_count() or 1) + 3, 400
    profiling.enable()
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(each):
                with profiling.span(f"probe.{i}"):
                    pass

        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        while any(t.is_alive() for t in pool):
            got += profiling.snapshot()
        for t in pool:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    got += profiling.snapshot()
    assert len(got) == threads * each
    assert len({(n, tid) for n, tid, _, _ in got}) == threads


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing") / "store"
    w = TrajStoreWriter(str(d))
    eps = synthetic.train_episodes(np.random.RandomState(3), (5, 3, 7, 4, 6, 2),
                                   port_config())
    w.append_batch([pack_record(e) for e in eps])
    w.close()
    return str(d)


def test_replay_loader_spans(store):
    """Read and collate on the producer's thread, once a batch each, the
    read of a batch before its collation; a fetch a record and a fill an
    episode on the loader's workers, each inside its batch's read or
    collate."""
    loader = replay.ReplayLoader(store, batch_size=2, max_len=8, seed=1)
    profiling.enable()
    batches = list(loader)
    spans = profiling.snapshot()
    assert len(batches) == len(loader) == 3
    by = {}
    for name, tid, _, _ in spans:
        by.setdefault(name, []).append(tid)
    assert set(by) == {"replay.read", "replay.collate", "replay.fetch",
                       "replay.fill"}
    assert len(by["replay.read"]) == len(by["replay.collate"]) == 3
    assert len(by["replay.fetch"]) == len(by["replay.fill"]) == 3 * 2
    producer = set(by["replay.read"]) | set(by["replay.collate"])
    assert len(producer) == 1
    me = threading.get_native_id()
    assert me not in producer
    assert me not in set(by["replay.fetch"]) | set(by["replay.fill"])
    reads = [s for s in spans if s[0] == "replay.read"]
    collates = [s for s in spans if s[0] == "replay.collate"]
    for (_, _, _, read_end), (_, _, collate_start, _) in zip(reads, collates):
        assert read_end <= collate_start
    for outer, inner in ((reads, "replay.fetch"), (collates, "replay.fill")):
        for _, _, start, end in outer:
            held = [s for s in spans if s[0] == inner
                    and start <= s[2] <= s[3] <= end]
            assert len(held) == 2, (inner, held)


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    return RolloutEngine(BasePolicy(port_config()), 2,
                         instruction_len=INSTR_LEN, device="cpu")


def test_engine_spans(engine):
    """act, update_map, act on the same instructions, act on new ones:
    the engine's spans; the text re-encode only when the tokens change,
    inside the act that needs it."""
    rng = np.random.RandomState(2)
    instr = tokens(rng, 2, (5, 9))
    engine.reset_state(2)
    masks = np.ones((2, 1), np.float32)
    profiling.enable()
    for t, kind in enumerate(("act", "update_map", "act", "act")):
        if t == 3:
            instr = tokens(rng, 2, (4, 7))
        batch = engine.batch_obs(raw_obs(rng, 2, t, instr))
        getattr(engine, kind)(batch, masks)
    spans = profiling.snapshot()
    count = {}
    for n in names(spans):
        count[n] = count.get(n, 0) + 1
    assert count == {"engine.act": 3, "engine.update_map": 1,
                     "engine.encode_text": 2}
    acts = [s for s in spans if s[0] == "engine.act"]
    for name, _, start, end in spans:
        if name == "engine.encode_text":
            assert any(a <= start and end <= b for _, _, a, b in acts)


def test_train_update_spans():
    torch.manual_seed(1)
    state = step_mod.create_train_state(BasePolicy(port_config()),
                                        device="cpu")
    update = step_mod.make_train_step(MonitorConfig())
    eps = synthetic.train_episodes(np.random.RandomState(5), (3, 4),
                                   port_config())
    batch = replay.collate_episodes(eps, max_len=8)
    profiling.enable()
    update(state, batch)
    (span,) = profiling.snapshot()
    name, tid, start, end = span
    assert name == "train.update"
    assert tid == threading.get_native_id() and 0 < start <= end


@pytest.mark.parametrize("case", ["clock", "profiler_records", "no_events"])
def test_spans_and_the_profiler(case, engine):
    """A profiler session alone records no span; a span's start lies
    within 1 ms of a ``record_function`` range opened beside it on the
    profile's clock; and no profile event bears a span's name (the
    benchmark counts every device-typed event as a device operation)."""
    if case != "profiler_records":
        profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("tracing.probe_range"):
            with profiling.span("probe.clock"):
                torch.ones(64).sum()
        if case == "no_events":
            rng = np.random.RandomState(4)
            engine.reset_state(2)
            batch = engine.batch_obs(raw_obs(rng, 2, 0,
                                             tokens(rng, 2, (3, 6))))
            engine.act(batch, np.ones((2, 1), np.float32))
    with profiling.span("probe.after"):
        pass
    spans = profiling.snapshot()
    events = prof.profiler.kineto_results.events()
    if case == "clock":
        rng_ev = next(e for e in events if e.name() == "tracing.probe_range")
        (start,) = [s[2] for s in spans if s[0] == "probe.clock"]
        assert abs(start - rng_ev.start_ns()) < 1_000_000
    elif case == "profiler_records":
        assert spans == []
        assert [e for e in events if e.name() == "tracing.probe_range"]
    else:
        assert names(spans)[-2:] == ["engine.act", "probe.after"]
        recorded = set(names(spans))
        assert not [e.name() for e in events if e.name() in recorded]
