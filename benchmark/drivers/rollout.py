"""Closed-loop collection traffic: the collector's lockstep against the
port's ``RolloutEngine``.

Every engine step serves all B envs, and the next starts when it
returns. The loop replays ``collect_dataset``'s step protocol: ``act`` on
every third global step and ``update_map`` on the others; after ``act``
the action and the UNet, depth-trunk and ego-map features go to the host
in fp16, after ``update_map`` the ego map; ``zero_hidden_at`` at each
env's 23rd step; then each env steps to its next frame, an episode end
sets its mask to 0 and brings a new instruction (so the next ``act``
re-encodes the text), and ``batch_obs`` stacks and uploads the batch.

Traffic keys (the workload file's ``traffic``): ``envs``,
``episode_steps`` [lo, hi], ``instruction_words`` [lo, hi],
``size_cycle`` (how many sizes a permuted set holds),
``trajectories_per_env``, the room (``room_m``, ``margin_m``,
``camera_m``, ``ceiling_m``), ``warmup_cycles``, ``profile_cycles``,
``samples`` (act and map-update steps compared with the reference) and
``sample_span`` (the window steps they are drawn from).
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import harness, profiling, system
from benchmark.counts import flops
from benchmark.counts import kernels as K
from benchmark.reference import mapping as ref_mapping
from benchmark.reference import policy as ref_policy
from benchmark.reference.precision import arithmetic
from benchmark.traffic.episodes import RolloutEpisodes
from benchmark.traffic.rooms import FramePool

LABELS = {"unet": "bench:unet", "mapping": "bench:mapping",
          "conv_site": "bench:conv_site"}
ACT_OUTPUTS = ("action", "prog", "hidden")
MAP_OUTPUTS = ("ego_map", "global_map")
FEATURE_OUTPUTS = ("rgb_features", "depth_features", "pred_sem_map")


def to_host_fp16(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float16).cpu().numpy()


class Collect:
    """The lockstep loop's state: each env's episode, its frame within it
    and its step count, the masks and the next batch."""

    def __init__(self, engine, pool: FramePool, episodes: list, spans: dict):
        self.engine, self.pool, self.episodes = engine, pool, episodes
        self.b = len(episodes)
        self.cur = [e.next() for e in episodes]
        self.k = [0] * self.b
        self.step_counts = [0] * self.b
        self.masks = np.zeros((self.b, 1), np.float32)
        self.count_step = 0
        self.text_changed = True
        self.encodes: list[int] = []   # the longest instruction of each
        self.spans = spans
        self.batch = engine.batch_obs(self.observations())

    def frames(self) -> list[int]:
        return [self.pool.index(i, self.cur[i][2], self.k[i])
                for i in range(self.b)]

    def observations(self) -> list[dict]:
        return [self.pool.frame(f, self.cur[i][1])
                for i, f in enumerate(self.frames())]

    def step(self, sample: dict | None = None) -> bool:
        """One engine step and the env step after it; returns whether it
        was an ``act``. ``sample``, when given, receives the step's inputs,
        the engine's state before it and its outputs."""
        eng = self.engine
        act = self.count_step % 3 == 0
        if sample is not None:
            sample.update(kind="act" if act else "update_map",
                          frames=self.frames(),
                          tokens=[c[1] for c in self.cur],
                          masks=self.masks.copy(),
                          hidden=eng.hidden.clone(),
                          global_map=eng.global_map.clone())
        if act:
            if self.text_changed:
                self.encodes.append(max(int((c[1] != 0).sum())
                                        for c in self.cur))
                self.text_changed = False
            out = eng.act(self.batch, self.masks)
            out.action.cpu().numpy()
            to_host_fp16(out.rgb_features)
            to_host_fp16(out.depth_features)
            to_host_fp16(out.ego_map)
            if sample is not None:
                sample["out"] = {
                    "action": out.action, "prog": out.prog,
                    "hidden": eng.hidden.clone(),
                    "global_map": eng.global_map.clone(),
                    "ego_map": out.ego_map,
                    "rgb_features": out.rgb_features,
                    "depth_features": out.depth_features,
                    "pred_sem_map": out.pred_sem_map}
        else:
            ego = eng.update_map(self.batch, self.masks)
            to_host_fp16(ego)
            if sample is not None:
                sample["out"] = {"ego_map": ego,
                                 "global_map": eng.global_map.clone()}
        self.count_step += 1
        for i in range(self.b):
            self.step_counts[i] += 1
            if self.step_counts[i] == 23:
                eng.zero_hidden_at(i)
        for i in range(self.b):
            self.k[i] += 1
            done = self.k[i] >= self.cur[i][0]
            self.masks[i, 0] = 0.0 if done else 1.0
            if done:
                self.cur[i] = self.episodes[i].next()
                self.k[i] = 0
                self.step_counts[i] = 0
                self.text_changed = True
        t0 = time.perf_counter()
        self.batch = eng.batch_obs(self.observations())
        self.spans.setdefault("batch_obs", []).append(time.perf_counter() - t0)
        return act


def install_labels(policy, cfg: dict) -> set[str]:
    from ws_mgmap_tpu_torch.models import policy as policy_mod

    profiling.label_path(policy, "net.rgb_encoder", LABELS["unet"])
    policy_mod.rgb_mapping_step = profiling.labelled(
        policy_mod.rgb_mapping_step, LABELS["mapping"])
    for path in dict.fromkeys(s.name for s in K.conv_sites(cfg)
                              if s.labelled):
        profiling.label_path(policy, path, LABELS["conv_site"])
    return set(LABELS.values())


def sample_steps(seed: int, traffic: dict) -> set[int]:
    """Step indices to compare: ``samples`` act steps and as many
    map-update steps, drawn from the first ``sample_span`` (about the
    steps a window holds)."""
    rng = np.random.default_rng([seed, 5])
    span = traffic["sample_span"]
    acts = np.arange(0, span, 3)
    maps = np.setdiff1d(np.arange(span), acts)
    n = traffic["samples"]
    return set(rng.choice(acts, n, replace=False).tolist()
               + rng.choice(maps, n, replace=False).tolist())


def run(ctx: harness.Ctx, keep: bool = False) -> harness.Outcome:
    cfg, t, dev = ctx.cfg, ctx.workload["traffic"], ctx.device
    b = t["envs"]
    system.apply_numerics(cfg)
    ctx.mark("imports")
    sd = system.weights(cfg, ctx.seed, dev)
    policy = system.build_policy(cfg, sd, dev)
    engine = system.engine(cfg, policy, b, dev)
    del policy
    ctx.mark("weights_and_engine")
    labels = install_labels(engine.policy, cfg) if ctx.trace else set()
    pool = FramePool(ctx.seed, b, t["trajectories_per_env"],
                     t["episode_steps"][1], t, cfg["rgb_hw"], cfg["depth_hw"],
                     dev)
    ctx.mark("frame_pool")

    def episodes(seed):
        return [RolloutEpisodes(seed, i, t, cfg["vocab_size"],
                                cfg["instruction_len"]) for i in range(b)]

    # warm-up on episodes of another seed, then a fresh state
    warm = Collect(engine, pool, episodes(ctx.seed + 1), {})
    for _ in range(3 * t["warmup_cycles"]):
        warm.step()
    engine.reset_state(b)
    ctx.mark("warm_up")
    spans: dict = {}
    loop = Collect(engine, pool, episodes(ctx.seed), spans)
    chosen = sample_steps(ctx.seed, t)
    samples = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    spans.clear()

    # the measured window
    t0 = time.perf_counter()
    setup_s = time.time() - ctx.t_start
    act_starts, steps, acts = [], 0, 0
    end = t0 + ctx.seconds
    while True:
        now = time.perf_counter()
        if now >= end and steps % 3 == 0:
            break
        sample = {} if steps in chosen else None
        if steps % 3 == 0:
            act_starts.append(now)
        acts += loop.step(sample)
        if sample is not None:
            samples.append(sample)
        steps += 1
    t1 = time.perf_counter()
    window_s = t1 - t0
    window_spans = {k: list(v) for k, v in spans.items()}
    window_encodes = list(loop.encodes)
    act_starts.append(t1)
    cycles_ms = [(y - x) * 1e3 for x, y in zip(act_starts, act_starts[1:])]
    frames = steps * b
    # sampled steps drawn past the window's close are still answered:
    # the loop runs on, untimed, for at most a minute
    late, deadline = steps, t1 + 60.0
    while late <= max(chosen) and time.perf_counter() < deadline:
        sample = {} if late in chosen else None
        loop.step(sample)
        if sample is not None:
            samples.append(sample)
        late += 1
    shapes = system.shapes(cfg)[0]
    window_flops = (acts * flops.act_flops(cfg, shapes, b)
                    + (steps - acts) * flops.update_map_flops(cfg, shapes, b)
                    + sum(flops.encode_flops(cfg, b, n) for n in window_encodes))
    metrics = {"rollout_frames_per_s": frames / window_s,
               "decision_cycle_ms_p95": statistics.quantiles(
                   cycles_ms, n=20, method="inclusive")[-1],
               "setup_s": setup_s}

    record = None
    if ctx.trace:
        while loop.count_step % 3:
            loop.step()
        n = t["profile_cycles"]
        prof_frames: list = []

        def sub_window():
            for _ in range(3 * n):
                prof_frames.append(loop.frames())
                loop.step()

        trace = profiling.profiled(sub_window, labels, {"cycles": n})
        record = harness.Record(
            spans=window_spans,
            counters={"splat": splat_work(cfg, pool, prof_frames, dev)},
            window={"seconds": window_s, "steps": steps, "acts": acts,
                    "frames": frames, "flops": window_flops,
                    "cycles": len(cycles_ms)},
            trace=trace, cfg=cfg, workload=ctx.workload)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del engine, loop, warm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(ctx, samples, sd, pool)
    out = harness.Outcome(metrics=metrics, checks=checks, attempted=frames,
                          failed=0, memory_peak_bytes=peak, record=record)
    if keep:
        out.kept = {"samples": samples, "sd": sd, "pool": pool}
    return out


def splat_work(cfg: dict, pool: FramePool, prof_frames: list, dev) -> dict:
    """The splat's valid pixels and frames in the profiled sub-window,
    counted by the benchmark's own binning of the same depth frames."""
    n_valid = frames = 0
    r = cfg["rgb_hw"]
    for idx in prof_frames:
        depth = torch.from_numpy(pool.depth[idx]).to(dev) * 10.0
        heading = -torch.from_numpy(pool.compass[idx]).to(dev).reshape(-1)
        ids = ref_mapping.cell_ids(
            depth, cfg["ego_map_size"], ref_mapping.grid_size(cfg), (r, r),
            heading if cfg["rotate_in_splat"] else None)
        n_valid += int((ids >= 0).sum())
        frames += len(idx)
    return {"n_valid": n_valid, "frames": frames, "pixels": r * r}


def reference_obs(sample: dict, pool: FramePool, dev) -> dict:
    idx = sample["frames"]
    return {"rgb": torch.from_numpy(pool.rgb[idx]).to(dev).float(),
            "depth": torch.from_numpy(pool.depth[idx]).to(dev),
            "gps": torch.from_numpy(pool.gps[idx]).to(dev),
            "compass": torch.from_numpy(pool.compass[idx]).to(dev),
            "instruction": torch.from_numpy(np.stack(sample["tokens"]))}


def reference_step(sd, cfg, sample, pool, dev) -> dict:
    obs = reference_obs(sample, pool, dev)
    masks = torch.from_numpy(sample["masks"]).to(dev)
    g = sample["global_map"].float()
    with torch.no_grad():
        if sample["kind"] == "act":
            return ref_policy.act(sd, cfg, obs, sample["hidden"].float(),
                                  masks, g)
        ego, new_g = ref_policy.update_map(sd, cfg, obs, masks, g)
        return {"ego_map": ego, "global_map": new_g}


def rel_terms(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(||got - want||^2, ||want||^2) over the whole batch."""
    got, want = got.float(), want.float()
    return float((got - want).square().sum()), float(want.square().sum())


def map_terms(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """The maps' terms, blind to a value landing one cell over: what each
    map holds above the other's 3x3 neighbourhood maximum (squared norm),
    and the reference's squared norm. bf16 coordinates bin some pixels
    into a neighbouring cell, as the configuration's precision allows; a
    map that missed an update, kept what a mask cleared or registered at
    the wrong place holds values nowhere near the other's."""
    got, want = got.float(), want.float()

    def dilate(x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)

    excess = ((got - dilate(want)).clamp(min=0).square().sum()
              + (want - dilate(got)).clamp(min=0).square().sum())
    return float(excess), float(want.square().sum())


def gaps(samples: list, outputs: list, refs: list) -> dict:
    """The three numbers compared. Each output's gap is pooled over all
    the sampled steps that produce it (the norm of the differences over
    the norm of the reference's values, every env of every step in it);
    a number is the worst of its outputs' gaps: the decision outputs, the
    maps (:func:`map_terms`) and the features."""
    groups = {"decision_gap": ACT_OUTPUTS, "map_gap": MAP_OUTPUTS,
              "features_gap": FEATURE_OUTPUTS}
    terms: dict[str, list[float]] = {}
    for got, want in zip(outputs, refs):
        for name, keys in groups.items():
            split = map_terms if name == "map_gap" else rel_terms
            for k in keys:
                if k in got:
                    num, den = split(got[k], want[k])
                    t = terms.setdefault(k, [0.0, 0.0])
                    t[0] += num
                    t[1] += den

    def gap(k):
        num, den = terms.get(k, (0.0, 0.0))
        if den == 0.0:
            return 0.0 if num == 0.0 else 1.0
        return (num / den) ** 0.5

    return {name: max(gap(k) for k in keys) for name, keys in groups.items()}


def judge(ctx: harness.Ctx, samples: list, sd: dict, pool: FramePool
          ) -> list:
    """The program's sampled outputs against the reference in fp32 (TF32
    off), each from the program's state before the step."""
    with arithmetic("fp32"):
        refs = [reference_step(sd, ctx.cfg, s, pool, ctx.device)
                for s in samples]
    g = gaps(samples, [s["out"] for s in samples], refs)
    limits = ctx.workload["limits"]
    checks = [harness.Check(k, v, limits[k]) for k, v in g.items()]
    if len(samples) < 2 * ctx.workload["traffic"]["samples"]:
        checks.append(harness.Check("samples_missing", float(
            2 * ctx.workload["traffic"]["samples"] - len(samples)), 0.0))
    return checks


def control_gaps(ctx: harness.Ctx, kept: dict, precision: str) -> dict:
    """The control: the reference in ``precision`` in the program's place,
    on the same sampled steps and states, against the reference in
    fp32."""
    samples, sd, pool = kept["samples"], kept["sd"], kept["pool"]
    with arithmetic(precision):
        low = [reference_step(sd, ctx.cfg, s, pool, ctx.device)
               for s in samples]
    with arithmetic("fp32"):
        refs = [reference_step(sd, ctx.cfg, s, pool, ctx.device)
                for s in samples]
    return gaps(samples, low, refs)
