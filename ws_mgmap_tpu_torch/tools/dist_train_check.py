#!/usr/bin/env python3
"""Data-parallel teacher forcing, checked: N ranks against one process.

    python -m ws_mgmap_tpu_torch.tools.dist_train_check single <world> <dir>
    python -m ws_mgmap_tpu_torch.tools.dist_train_check rank <r> <world> <dir>

The port's counterpart of ``tools/dist_train_check.py``; it imports no
JAX, so the CPU tests and ``chip_smoke.py`` launch ranks with it
(:func:`launch_ranks`). ``<dir>/spec.json`` says what to run::

    {"weights": "weights.pt" (a state_dict in <dir>) or null,
     "seed": 0,            # null weights: random full-width weights
     "config": {...}, "mapper": {...},   # MGMapConfig, MapperParams fields
     "device": "cpu" or "cuda", "backend": null or "gloo",
     "threads": null or the CPU threads of a process,
     "timeout_s": 120,     # a collective that waits longer fails
     "runs": [{"store": "store", "batch_size": 2, "max_len": 8,
               "dtype": "float64", "remat": false,
               "timed": null or [rounds, updates per round]}, ...]}

``rank`` joins the process group of ``world`` ranks through a file store
(``<dir>/rendezvous``), reads its shard of each run's store through
``ReplayLoader(rank, world, fixed_len=world > 1)``, as the trainer does,
and makes one data-parallel update from the initial weights
(``make_train_step(distributed=True)``); ``single`` makes the plain
update, with no process group, on the global batch: every rank's loader
batch, concatenated in rank order. Each writes ``<dir>/rank<r>.pt`` or
``<dir>/single.pt``: per run the batch shape, the metrics, the gradients,
the state after the update, the all-reduces the update issued (count and
bytes), the gradient bucket's bytes and the kernels' launches; a timed run
adds its ms per update (host clock, median and range of the rounds), peak
memory and the share of the update spent in all-reduce.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.ops.kernels import splat as ksplat
from ws_mgmap_tpu_torch.ops.mapping import MapperParams
from ws_mgmap_tpu_torch.parallel import mesh
from ws_mgmap_tpu_torch.train import step
from ws_mgmap_tpu_torch.train.losses import MonitorConfig
from ws_mgmap_tpu_torch.train.replay import ReplayLoader

ROOT = Path(__file__).resolve().parents[2]


def kernel_launches() -> dict[str, int]:
    """The launch counts of the port's kernel wrappers in this process."""
    return {"splat_max": ksplat.splat_max.launches,
            "conv_wgmma": kconv.conv3x3_bn_relu_wgmma.launches,
            "conv_direct": kconv.conv3x3_bn_relu_direct.launches}


@contextlib.contextmanager
def logged_all_reduces(log: list):
    """Within the block, every ``torch.distributed.all_reduce`` (those of
    ``parallel/mesh.py``, the differentiable one's backward included)
    appends (bytes, timer) to ``log``; ``all_reduce_ms`` reads the
    timers."""
    real = dist.all_reduce

    def logged(tensor, *args, **kwargs):
        if tensor.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(tensor, *args, **kwargs)
            end.record()
            timer = (start, end)
        else:
            t0 = time.perf_counter()
            out = real(tensor, *args, **kwargs)
            timer = (time.perf_counter() - t0) * 1e3
        log.append((tensor.numel() * tensor.element_size(), timer))
        return out

    dist.all_reduce = logged
    try:
        yield log
    finally:
        dist.all_reduce = real


def all_reduce_ms(log: list) -> float:
    """The summed ms of the logged all-reduces (CUDA events on the card:
    what the compute stream waited; synchronize first)."""
    return sum(t if isinstance(t, float) else t[0].elapsed_time(t[1])
               for _, t in log)


def load_spec(directory: Path) -> dict:
    return json.loads((directory / "spec.json").read_text())


def initial_policy(spec: dict, directory: Path) -> BasePolicy:
    """The initial weights on the host: the spec's state_dict, or random
    full-width weights from its seed."""
    if spec.get("weights") is None:
        from ws_mgmap_tpu_torch.tools.synthetic import random_policy
        return random_policy(spec["seed"], rotate_in_splat=False)
    policy = BasePolicy(MGMapConfig(**spec.get("config", {}),
                                    mapper=MapperParams(**spec.get("mapper",
                                                                   {}))))
    policy.load_state_dict(torch.load(directory / spec["weights"]),
                           strict=True)
    return policy


def rank_batch(run: dict, directory: Path, rank: int, world: int) -> dict:
    """Rank ``rank``'s first batch of the run's store, as the trainer's
    loader gives it (the whole epoch is read, so its prefetch thread
    ends)."""
    loader = ReplayLoader(str(directory / run["store"]), run["batch_size"],
                          rank=rank, world_size=world,
                          max_len=run["max_len"], fixed_len=world > 1)
    return list(loader)[0]


def concat_batches(batches: list[dict]) -> dict:
    """Leaves concatenated on the episode axis, in the given order."""
    if isinstance(batches[0], dict):
        return {k: concat_batches([b[k] for b in batches]) for k in batches[0]}
    return np.concatenate(batches)


def cast_batch(batch: dict, dtype: torch.dtype) -> dict:
    """float32 leaves in ``dtype`` (the tokens and the semantic map keep
    theirs)."""
    if isinstance(batch, dict):
        return {k: cast_batch(v, dtype) for k, v in batch.items()}
    if batch.dtype == np.float32 and dtype == torch.float64:
        return batch.astype(np.float64)
    return batch


def snapshot(state, metrics: dict) -> dict:
    """An update's results, copied to the host: {"metrics": floats,
    "grads": the parameters' gradients, "state": the policy's
    state_dict}."""
    def on_host(t):
        return t.detach().to("cpu", copy=True)

    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={k: on_host(p.grad) for k, p in
               state.policy.named_parameters() if p.grad is not None},
        state={k: on_host(v) for k, v in state.policy.state_dict().items()})


def run_updates(spec: dict, directory: Path, rank: int | None, world: int,
                device: torch.device) -> list[dict]:
    """One update per run of the spec from the initial weights: the
    data-parallel update on this rank's batch (``rank`` given; the process
    group is up), or the plain one on the global batch (``rank`` None)."""
    base = initial_policy(spec, directory)
    results = []
    for run in spec["runs"]:
        dtype = getattr(torch, run["dtype"])
        if rank is None:
            batch = concat_batches([rank_batch(run, directory, r, world)
                                    for r in range(world)])
        else:
            batch = rank_batch(run, directory, rank, world)
        batch = cast_batch(batch, dtype)
        state = step.create_train_state(copy.deepcopy(base).to(dtype),
                                        device=device)
        if rank is not None:
            mesh.replicate(state.policy)
        update = step.make_train_step(MonitorConfig(), remat=run["remat"],
                                      distributed=rank is not None)
        launches = kernel_launches()
        log: list = []
        with logged_all_reduces(log):
            metrics = update(state, batch)
        out = dict(
            N=int(batch["weights"].shape[0]), T=int(batch["weights"].shape[1]),
            **snapshot(state, metrics),
            # the gradient bucket is the update's last all-reduce
            allreduces=len(log), allreduce_bytes=[b for b, _ in log],
            bucket_bytes=log[-1][0] if log else 0)
        if run.get("timed"):
            out["timed"] = timed_updates(state, update, batch, *run["timed"])
        out["launches"] = {k: v - launches[k]
                           for k, v in kernel_launches().items()}
        results.append(out)
    return results


def timed_updates(state, update, batch, rounds: int, per_round: int) -> dict:
    """Host-clock ms per update over synchronized rounds (median and
    range), the frames per second, peak device memory and the share of
    the update that the compute stream spent in all-reduce."""
    cuda = state.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(state.device)

    update(state, batch)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(state.device)
    round_ms, log = [], []
    with logged_all_reduces(log):
        for _ in range(rounds):
            sync()
            t0 = time.perf_counter()
            for _ in range(per_round):
                update(state, batch)
            sync()
            round_ms.append((time.perf_counter() - t0) * 1e3 / per_round)
    ms = float(np.median(round_ms))
    n, t = batch["weights"].shape
    updates = rounds * per_round
    ar_ms = all_reduce_ms(log) / updates
    return dict(ms_per_update=ms, ms_per_update_range=[min(round_ms),
                                                       max(round_ms)],
                frames_per_s=n * t * 1e3 / ms,
                all_reduce_ms=ar_ms,
                all_reduce_share=ar_ms / float(np.mean(round_ms)),
                peak_mem_gib=(torch.cuda.max_memory_allocated(state.device)
                              / 2**30 if cuda else None))


def main_rank(rank: int, world: int, directory: Path) -> None:
    spec = load_spec(directory)
    if spec.get("threads") and spec["device"] == "cpu":
        torch.set_num_threads(spec["threads"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    got_rank, got_world, device = mesh.init_distributed(
        spec["device"] if spec["device"] == "cpu" else None,
        init_method=f"file://{directory / 'rendezvous'}",
        timeout_s=spec.get("timeout_s", 600.0), backend=spec.get("backend"))
    if (got_rank, got_world) != (rank, world):
        raise RuntimeError(f"rank {got_rank} of {got_world} from the "
                           f"environment, {rank} of {world} asked")
    try:
        results = run_updates(spec, directory, rank, world, device)
        torch.save(results, directory / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(json.dumps([{k: v for k, v in r.items()
                       if k not in ("grads", "state", "allreduce_bytes")}
                      for r in results]), flush=True)


def main_single(world: int, directory: Path) -> None:
    spec = load_spec(directory)
    if spec.get("threads") and spec["device"] == "cpu":
        torch.set_num_threads(spec["threads"])
    device = torch.device("cuda" if spec["device"] == "cuda" else "cpu")
    results = run_updates(spec, directory, None, world, device)
    torch.save(results, directory / "single.pt")


def launch_ranks(world: int, directory: Path, timeout_s: float,
                 shared_card: bool = False) -> list[str]:
    """Runs ``rank r world directory`` for r < world in subprocesses (a
    fresh interpreter each: never a fork of a process that holds JAX or a
    CUDA context) and waits at most ``timeout_s`` for all of them; on
    expiry or a failure every rank is killed and this raises with their
    output. ``shared_card``: every rank on card 0 (``LOCAL_RANK`` 0).
    Returns each rank's output."""
    procs = []
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK="0" if shared_card else str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ws_mgmap_tpu_torch.tools.dist_train_check",
             "rank", str(r), str(world), str(directory)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout_s
    outs: list[str | None] = [None] * world
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [(out if out is not None else p.communicate()[0])[-2000:]
                 for p, out in zip(procs, outs)]
        raise RuntimeError(f"{world} ranks did not finish in {timeout_s} s:\n"
                           + "\n".join(tails))
    failed = [(r, out[-3000:]) for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"--- rank {r}\n{out}" for r, out in failed))
    return outs


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "single":
        main_single(int(sys.argv[2]), Path(sys.argv[3]))
    elif mode == "rank":
        main_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    else:
        raise SystemExit(f"unknown mode {mode}")
