"""Where a rollout step's time goes on the card.

    python -m ws_mgmap_tpu_torch.tools.profile_update_map \
        [--step update_map act] [--batch 6 24]

Drives ``RolloutEngine.update_map`` (the map-update step) or
``RolloutEngine.act`` (the decision step) at full width in the production
mode (bf16 + rotate-in-splat, random weights from a seed, observations on
the card, the instruction already encoded), then traces a few steps with
``torch.profiler`` and prints one JSON line per step kind and batch: the
host-clock ms/step, the device's busy time per step (the union of its
kernels' intervals) and idle share, kernels per step, and device ms per
step by kernel kind (``device_ms_by_kind``) and by the module that
launched the kernel (``device_ms_by_module``: the hand-written kernels
by name, every other kernel under the labelled module whose forward
issued it, found through the profiler's op tree). Needs a CUDA card.
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
from ws_mgmap_tpu_torch.tools.synthetic import random_policy, wall_obs
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
    ("heads", ("action_distribution", "critic", "prog_pred")),
    ("linears (rgb, depth)", ("net.rgb_linear", "net.depth_linear")),
]
MAPPING_LABEL = "mapping chain (projection, registration)"


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


def _by_module(events, labels: set[str], steps: int) -> dict[str, float]:
    """Device ms per step by module of the library kernels: each CPU op's
    kernels go to the nearest range above the op named in ``labels``. The
    hand-written kernels are left out (they are counted by name)."""
    out: dict[str, float] = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        label, p = None, e
        while p is not None and label is None:
            label = p.name if p.name in labels else None
            p = p.cpu_parent
        for k in e.kernels:
            if _kind(k.name, OWN_KERNELS) is None:
                group = label or "unlabelled"
                out[group] = out.get(group, 0.0) + k.duration / 1e3 / steps
    return out


def profile_step(policy: BasePolicy, step: str, b: int, steps: int = 6
                 ) -> dict:
    eng = RolloutEngine(policy, b, compute_dtype=torch.bfloat16)
    label_modules(eng.policy)
    obs = eng.batch_obs(wall_obs(b, 0.2, np.random.RandomState(b)))
    masks = np.ones((b, 1))
    run = functools.partial(getattr(eng, step), obs, masks)
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
    labels = {label for label, _ in MODULES} | {MAPPING_LABEL}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in labels]
    by_kind: dict[str, float] = {}
    spans = []
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        kind = _kind(e.name) or "other elementwise / copy"
        by_kind[kind] = by_kind.get(kind, 0.0) + (end - start) / 1e3 / steps
    total_ms = sum(by_kind.values())
    by_module = _by_module(events, labels, steps)
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
            "device_ms_by_module": ordered(by_module)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", nargs="+", choices=("update_map", "act"),
                    default=["update_map"])
    ap.add_argument("--batch", type=int, nargs="+", default=[6, 24])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_update_map needs a CUDA card")
    policy = random_policy(0, rotate_in_splat=True)
    policy_mod.rgb_mapping_step = _labelled(policy_mod.rgb_mapping_step,
                                            MAPPING_LABEL)
    for step in args.step:
        for b in args.batch:
            print(json.dumps(profile_step(policy, step, b)), flush=True)


if __name__ == "__main__":
    main()
