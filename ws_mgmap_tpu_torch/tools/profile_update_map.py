"""Where the map-update step's time goes on the card.

    python -m ws_mgmap_tpu_torch.tools.profile_update_map [--batch 6 24]

Drives ``RolloutEngine.update_map`` at full width in the production mode
(bf16 + rotate-in-splat, random weights from a seed, observations on the
card), then traces a few steps with ``torch.profiler`` and prints one JSON
line per batch: the host-clock ms/step, the device's busy time per step
(the union of its kernels' intervals) and idle share, and device time per
step by kernel group, largest first. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.tools.synthetic import random_policy, wall_obs
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

# kernel-name fragments -> group, first match wins: the fused convs before
# the library group, whose "conv" and "sm90" would also match their names
GROUPS = [
    ("fused conv3x3 wgmma (csrc/conv3x3_wgmma.cu)",
     ("conv3x3_wgmma_kernel",)),
    ("fused conv3x3 direct (csrc/conv3x3.cu)", ("conv3x3_kernel",)),
    ("splat (csrc/splat.cu)", ("splat_max_kernel",)),
    ("library conv (cuDNN)", ("cudnn", "xmma", "conv", "implicit", "gemm",
                              "nchwToNhwc", "nhwcToNchw", "sm90")),
    ("grid_sample rotation", ("grid_sampler", "affine")),
    ("upsample", ("upsample",)),
    ("batch_norm", ("batch_norm", "bn_")),
    ("index / gather / scatter", ("index", "gather", "scatter")),
]


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other elementwise / copy"


def profile_batch(policy: BasePolicy, b: int, steps: int = 6) -> dict:
    eng = RolloutEngine(policy, b, compute_dtype=torch.bfloat16)
    obs = eng.batch_obs(wall_obs(b, 0.2, np.random.RandomState(b)))
    masks = np.ones((b, 1))
    for _ in range(3):
        eng.update_map(obs, masks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.update_map(obs, masks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group: dict[str, float] = {}
    spans = []
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + (
            end - start) / 1e3 / steps
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
    first = min(s for s, _ in spans)
    last = max(e for _, e in spans)
    busy_ms = busy / 1e3 / steps
    return {"batch": b, "steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_span_ms_per_step": (last - first) / 1e3 / steps,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": len(kernels) / steps,
            "device_ms_by_group": dict(sorted(by_group.items(),
                                              key=lambda kv: -kv[1]))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[6, 24])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_update_map needs a CUDA card")
    policy = random_policy(0, rotate_in_splat=True)
    for b in args.batch:
        print(json.dumps(profile_batch(policy, b)), flush=True)


if __name__ == "__main__":
    main()
