"""Where a rollout step's or a training update's time goes on the card.

    python -m ws_mgmap_tpu_torch.tools.profile_update_map \
        [--step update_map act train] [--batch 6 24]

Drives ``RolloutEngine.update_map`` (the map-update step) or
``RolloutEngine.act`` (the decision step) at full width in the production
mode (bf16 + rotate-in-splat, random weights from a seed, observations on
the card, the instruction already encoded), or the teacher-forcing update
(``train/step.py``, fp32 with TF32 off, the training cell of
``tools/synthetic.py``: 5 episodes x 64 steps; ``--batch`` does not apply),
then traces a few steps with ``torch.profiler`` and prints one JSON line
per step kind and batch: the host-clock ms/step, the device's busy time
per step (the union of its kernels' intervals) and idle share, kernels per
step, and device ms per step by kernel kind (``device_ms_by_kind``) and
by the module that launched the kernel (``device_ms_by_module``: the
hand-written kernels by name, every other kernel under the labelled module
whose forward issued it, found through the profiler's op tree; a backward
kernel goes to the module of the forward op with its autograd sequence
number; the update's batch upload, losses and Adam step have labels of
their own). For the update, ``device_ms_backward`` is the share of the
autograd engine's kernels. ``top_kernels_ms`` lists the 12 kernels with
the most device time. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from ws_mgmap_tpu_torch.models import policy as policy_mod
from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.tools.synthetic import (TRAIN_LENGTHS, random_policy,
                                                train_episodes, wall_obs)
from ws_mgmap_tpu_torch.train import step as step_mod
from ws_mgmap_tpu_torch.train.losses import MonitorConfig
from ws_mgmap_tpu_torch.train.replay import collate_episodes
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

# kernel-name fragments -> kind, first match wins: the fused convs before
# the library group, whose "conv" and "sm90" would also match their names
KINDS = [
    ("fused conv3x3 wgmma (csrc/conv3x3_wgmma.cu)",
     ("conv3x3_wgmma_kernel",)),
    ("fused conv3x3 direct (csrc/conv3x3.cu)", ("conv3x3_kernel",)),
    ("splat (csrc/splat.cu)", ("splat_max_kernel",)),
    ("library conv (cuDNN)", ("cudnn", "xmma", "conv", "implicit", "gemm",
                              "nchwToNhwc", "nhwcToNchw", "sm90")),
    ("grid_sample rotation", ("grid_sampler", "affine")),
    ("upsample", ("upsample",)),
    ("batch_norm", ("batch_norm", "bn_")),
    ("group_norm", ("group_norm", "groupnorm")),
    ("index / gather / scatter", ("index", "gather", "scatter")),
]
# the hand-written kernels keep their own group in the module breakdown
OWN_KERNELS = KINDS[:3]
# module groups: (label, attribute paths under the policy); a module's
# forward, or the method, runs inside a range named by the label
MODULES = [
    ("UNet", ("net.rgb_encoder",)),
    ("depth ResNet50 (GroupNorm)", ("net.depth_encoder",)),
    ("map modules", ("net.map_encoder", "net.map_decoder",
                     "net.map_classfier", "net.map_encoded_linear",
                     "net.map_classified_linear", "net.map_cated_linear",
                     "net.map_linear")),
    ("RNN and attention", ("net._core",)),
    ("biLSTM (instruction encoder)", ("net.instruction_encoder",)),
    ("heads", ("action_distribution", "critic", "prog_pred")),
    ("linears (rgb, depth)", ("net.rgb_linear", "net.depth_linear")),
]
MAPPING_LABEL = "mapping chain (projection, registration)"
LOSSES_LABEL, OPTIMIZER_LABEL = "losses", "optimizer (Adam)"
UPLOAD_LABEL = "batch upload (host to device)"
BACKWARD = "autograd::engine::evaluate_function"


def _kind(name: str, kinds=KINDS) -> str | None:
    low = name.lower()
    for kind, keys in kinds:
        if any(k.lower() in low for k in keys):
            return kind
    return None


def _labelled(fn, label: str):
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)
    return wrapped


def label_modules(policy: BasePolicy) -> None:
    """Wrap the groups of :data:`MODULES` of ``policy`` (the engine's own
    copy: a deep copy of a wrapped module would call the original) in
    ``record_function`` ranges named by their labels."""
    for label, paths in MODULES:
        for path in paths:
            *parents, last = path.split(".")
            owner = policy
            for p in parents:
                owner = getattr(owner, p)
            target = getattr(owner, last)
            if isinstance(target, torch.nn.Module):
                target.forward = _labelled(target.forward, label)
            else:
                setattr(owner, last, _labelled(target, label))


def _busy_us(spans) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def _by_module(events, labels: set[str], steps: int
               ) -> tuple[dict[str, float], float]:
    """Device ms per step by module of the library kernels, and of the
    backward pass's kernels: each CPU op's kernels go to the nearest range
    above the op named in ``labels``; an op of the backward pass has none,
    and goes to the label of the forward op with its autograd sequence
    number. The hand-written kernels are left out (they are counted by
    name)."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    # a forward op records the number the next autograd node will take,
    # so the last op with a number is the one that made its node
    seq_label = {}
    for e in sorted(cpu, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and not any(p.name.startswith(BACKWARD)
                                          for p in _ancestors(e)):
            seq_label[e.sequence_nr] = next(
                (p.name for p in _ancestors(e) if p.name in labels), None)
    out: dict[str, float] = {}
    backward = 0.0
    for e in cpu:
        if not e.kernels:
            continue
        chain = list(_ancestors(e))
        label = next((p.name for p in chain if p.name in labels), None)
        in_backward = any(p.name.startswith(BACKWARD) for p in chain)
        if label is None and in_backward:
            label = next((seq_label[p.sequence_nr] for p in chain
                          if seq_label.get(p.sequence_nr)), None)
        for k in e.kernels:
            if _kind(k.name, OWN_KERNELS) is None:
                group = label or "unlabelled"
                out[group] = out.get(group, 0.0) + k.duration / 1e3 / steps
            if in_backward:
                backward += k.duration / 1e3 / steps
    return out, backward


def rollout_step(policy: BasePolicy, step: str, b: int):
    """One production step of the engine, its modules labelled."""
    eng = RolloutEngine(policy, b, compute_dtype=torch.bfloat16)
    label_modules(eng.policy)
    obs = eng.batch_obs(wall_obs(b, 0.2, np.random.RandomState(b)))
    return functools.partial(getattr(eng, step), obs, np.ones((b, 1)))


def train_update(policy: BasePolicy):
    """One update of the training cell (fp32, TF32 off from here on, as
    JAX trains in full fp32), its modules, losses and optimizer step
    labelled; the policy becomes the train state's."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = step_mod.create_train_state(policy)
    label_modules(state.policy)
    state.optimizer.step = _labelled(state.optimizer.step, OPTIMIZER_LABEL)
    batch = collate_episodes(train_episodes(np.random.RandomState(11),
                                            TRAIN_LENGTHS))
    update = step_mod.make_train_step(MonitorConfig())
    return functools.partial(update, state, batch)


def profile_step(run, step: str, b: int, steps: int = 6) -> dict:
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.events()
    # device events, less the labels' own ranges (the profiler mirrors a
    # record_function range onto the device timeline)
    labels = ({label for label, _ in MODULES}
              | {MAPPING_LABEL, LOSSES_LABEL, OPTIMIZER_LABEL, UPLOAD_LABEL})
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in labels]
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    spans = []
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        kind = _kind(e.name) or "other elementwise / copy"
        ms = (end - start) / 1e3 / steps
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        by_name[e.name[:120]] = by_name.get(e.name[:120], 0.0) + ms
    total_ms = sum(by_kind.values())
    by_module, backward_ms = _by_module(events, labels, steps)
    by_module.update({k: by_kind.get(k, 0.0) for k, _ in OWN_KERNELS})
    # device time the op tree does not link to a CPU op (copies, if any)
    by_module["not linked to an op"] = total_ms - sum(by_module.values())
    busy_ms = _busy_us(spans) / 1e3 / steps
    first = min(s for s, _ in spans)
    last = max(e for _, e in spans)

    def ordered(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return {"step": step, "batch": b, "steps": steps,
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_span_ms_per_step": (last - first) / 1e3 / steps,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": len(kernels) / steps,
            "device_ms_by_kind": ordered(by_kind),
            "device_ms_by_module": ordered(by_module),
            "device_ms_backward": backward_ms,
            "top_kernels_ms": dict(list(ordered(by_name).items())[:12])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", nargs="+",
                    choices=("update_map", "act", "train"),
                    default=["update_map"])
    ap.add_argument("--batch", type=int, nargs="+", default=[6, 24])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_update_map needs a CUDA card")
    policy = random_policy(0, rotate_in_splat=True)
    policy_mod.rgb_mapping_step = _labelled(policy_mod.rgb_mapping_step,
                                            MAPPING_LABEL)
    step_mod.total_loss = _labelled(step_mod.total_loss, LOSSES_LABEL)
    step_mod.upload_batch = _labelled(step_mod.upload_batch, UPLOAD_LABEL)
    for step in args.step:
        if step == "train":
            n = len(TRAIN_LENGTHS)
            print(json.dumps(profile_step(train_update(
                random_policy(2, rotate_in_splat=True)), step, n, steps=2)),
                flush=True)
            continue
        for b in args.batch:
            print(json.dumps(profile_step(rollout_step(policy, step, b),
                                          step, b)), flush=True)


if __name__ == "__main__":
    main()
