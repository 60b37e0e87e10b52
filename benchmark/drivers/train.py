"""Teacher-forcing traffic: replay episodes through the port's trajectory
store and ``ReplayLoader`` into the update of ``make_train_step``, as
``DaggerTrainer`` runs an epoch.

Set-up writes the seeded episodes once into a store under the run's
TMPDIR, builds the train state and drives it through its first updates
(one epoch, so every T bucket of the traffic is warmed up); the
reference follows the first three. The window then trains epoch after
epoch, each batch taken from the loader's prefetch thread.

Traffic keys: ``episodes``, ``episode_steps`` [lo, hi] (subsampled
steps), ``instruction_words`` [lo, hi], ``batch_size``, ``max_len``,
``followed`` (the updates the reference follows), ``profile_updates``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import harness, profiling, system
from benchmark.counts import flops
from benchmark.reference import train as ref_train
from benchmark.reference.precision import arithmetic
from benchmark.traffic.episodes import replay_episodes

LABELS = {"map_modules": "bench:map_modules", "upload": "bench:upload"}
MAP_MODULES = ("net.map_encoder", "net.map_decoder", "net.map_classfier",
               "net.map_encoded_linear", "net.map_classified_linear",
               "net.map_cated_linear", "net.map_linear")
ADAM_B1 = 0.9


def monitors(cfg: dict) -> dict:
    return dict(cfg["monitors"])


def install_labels(policy) -> set[str]:
    from ws_mgmap_tpu_torch.train import step as step_mod

    for path in MAP_MODULES:
        profiling.label_path(policy, path, LABELS["map_modules"])
    step_mod.upload_batch = profiling.labelled(step_mod.upload_batch,
                                               LABELS["upload"])
    return set(LABELS.values())


def write_store(directory: str, episodes: list) -> None:
    """The episodes as collection leaves them: in the store, and on the
    disk (synced in set-up, so that no write-back runs into the window:
    a trainer reads a store written long before)."""
    from ws_mgmap_tpu_torch.data.trajstore import TrajStoreWriter, pack_record

    writer = TrajStoreWriter(directory)
    writer.append_batch([pack_record(e) for e in episodes])
    writer.flush()
    writer.close()
    for name in os.listdir(directory):
        fd = os.open(os.path.join(directory, name), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def batches(loader, spans: dict):
    """The loader's batches epoch after epoch; each wait for the next one
    is a host span."""
    while True:
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                break
            spans.setdefault("loader_wait", []).append(
                time.perf_counter() - t0)
            yield b


def run(ctx: harness.Ctx, keep: bool = False) -> harness.Outcome:
    from ws_mgmap_tpu_torch.train import step as step_mod
    from ws_mgmap_tpu_torch.train.losses import MonitorConfig
    from ws_mgmap_tpu_torch.train.replay import ReplayLoader

    cfg, t, dev = ctx.cfg, ctx.workload["traffic"], ctx.device
    system.apply_numerics(cfg)
    ctx.mark("imports")
    sd = system.weights(cfg, ctx.seed, dev)
    episodes = replay_episodes(ctx.seed, t, cfg, dev)
    ctx.mark("weights_and_episodes")
    store = ctx.tmp / "store"
    write_store(str(store), episodes)
    ctx.mark("store_written")
    policy = system.build_policy(cfg, sd, dev)
    state = step_mod.create_train_state(policy, cfg["lr"], device=dev)
    del policy
    labels = install_labels(state.policy) if ctx.trace else set()
    update = step_mod.make_train_step(MonitorConfig(**monitors(cfg)),
                                      remat=False)
    loader_seed = ctx.seed % (2 ** 31)
    loader = ReplayLoader(str(store), t["batch_size"], max_len=t["max_len"],
                          seed=loader_seed)
    spans: dict = {}
    feed = batches(loader, spans)

    # the first updates, followed by the reference
    named = [(n, p) for n, p in state.policy.named_parameters()
             if p.requires_grad]
    start = {n: p.detach().clone() for n, p in named}
    losses, first_grad = [], {}
    per_epoch = len(loader)
    for k in range(max(t["followed"], per_epoch)):
        m = update(state, next(feed))
        if k < t["followed"]:
            losses.append(float(m["loss"]))
        if k == 0:
            opt = state.optimizer.state
            first_grad = {n: (float(opt[p]["exp_avg"].norm()) / (1 - ADAM_B1)
                              if p in opt else None) for n, p in named}
        if k + 1 == t["followed"]:
            change = {n: float((p.detach() - start[n]).norm())
                      for n, p in named}
    del start
    ctx.mark("first_updates")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    spans.clear()

    shapes = system.shapes(cfg)[0]
    frame_flops = flops.train_flops(cfg, shapes, 0)
    word_flops = flops.train_flops(cfg, shapes, 1) - frame_flops

    # the measured window
    t0 = time.perf_counter()
    setup_s = time.time() - ctx.t_start
    updates = valid = 0
    window_flops = 0.0
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        batch = next(feed)
        float(update(state, batch)["loss"])
        frames = (batch["weights"] > 0).sum(1)
        words = (batch["obs"]["instruction"][:, 0] != 0).sum(-1)
        valid += int(frames.sum())
        window_flops += float(frame_flops * frames.sum()
                              + word_flops * (words * frames).sum())
        updates += 1
    window_s = time.perf_counter() - t0
    window_spans = {k: list(v) for k, v in spans.items()}
    metrics = {"train_frames_per_s": valid / window_s, "setup_s": setup_s}

    record = None
    if ctx.trace:
        n = t["profile_updates"]

        def sub_window():
            for _ in range(n):
                update(state, next(feed))

        trace = profiling.profiled(sub_window, labels, {"updates": n},
                                   backward=True)
        record = harness.Record(
            spans=window_spans, counters={},
            window={"seconds": window_s, "updates": updates, "valid": valid,
                    "flops": window_flops},
            trace=trace, cfg=cfg, workload=ctx.workload)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    feed.close()
    del state, update, feed, loader
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    program = {"losses": losses, "first_grad": first_grad, "change": change}
    followed = reference_batches(ctx, episodes)
    with arithmetic("fp32"):
        ref = ref_train.follow(sd, cfg, followed, cfg["lr"], monitors(cfg),
                               dev)
    checks = judge(ctx, program, ref)
    out = harness.Outcome(metrics=metrics, checks=checks,
                          attempted=updates, failed=0,
                          memory_peak_bytes=peak, record=record)
    if keep:
        out.kept = {"program": program, "ref": ref, "sd": sd,
                    "followed": followed}
    return out


def reference_batches(ctx: harness.Ctx, episodes: list) -> list[dict]:
    """The first epoch's batches as the reference orders and collates
    them from the benchmark's own episodes."""
    t = ctx.workload["traffic"]
    order = ref_train.epoch_batches(len(episodes), t["batch_size"],
                                    ctx.seed % (2 ** 31))
    return [ref_train.collate([episodes[i] for i in idx], t["max_len"])
            for idx in order[:t["followed"]]]


def leaf_gap(got, want, scale: float) -> float:
    if got is None and want is None:
        return 0.0
    if got is None or want is None:
        return 1.0
    return abs(got - want) / max(want, scale)


def judge(ctx: harness.Ctx, program: dict, ref: dict) -> list:
    """Each followed update's loss (relative), and by the worst leaf the
    first gradient's norm and the parameters' change's norm, each gap
    measured against the reference's norm of that leaf or of the median
    leaf, whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the change."""
    limits = ctx.workload["limits"]
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(program["losses"], ref["losses"]))
    g_ref = ref["first_grad"]
    norms = [v for v in g_ref.values() if v is not None]
    med_g = float(np.median(norms))
    grad_gap = max(leaf_gap(program["first_grad"].get(k), g_ref[k], med_g)
                   for k in g_ref)
    moving = [k for k in g_ref if g_ref[k] is not None
              and g_ref[k] >= 1e-3 * med_g]
    med_c = float(np.median([ref["change"][k] for k in moving]))
    change_gap = max(leaf_gap(program["change"].get(k), ref["change"][k],
                              med_c) for k in moving)
    values = {"loss_gap": loss_gap, "grad_gap": grad_gap,
              "change_gap": change_gap}
    return [harness.Check(k, v, limits[k]) for k, v in values.items()]


def control_gaps(ctx: harness.Ctx, kept: dict, precision: str) -> dict:
    """The control: the reference's three updates in ``precision`` in the
    program's place, against the reference in fp32."""
    with arithmetic(precision):
        low = ref_train.follow(kept["sd"], ctx.cfg, kept["followed"],
                               ctx.cfg["lr"], monitors(ctx.cfg), ctx.device)
    checks = judge(ctx, low, kept["ref"])
    return {c.name: c.value for c in checks}
