#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ws_mgmap_tpu_torch/ops/kernels/csrc``
(into ``build/ws_mgmap_tpu_torch/``), holds each kernel against its plain
PyTorch twin at the main path's shapes and times both, then drives the
map-update step (``RolloutEngine.update_map``) at full width: the
ResNet18-UNet over 224^2 RGB, 256^2 depth, 100^2 ego and 240^2 global maps,
random weights from a seed. Production mode (bf16 + rotate-in-splat) runs
at B=6 and B=24 on a "wall 3 m ahead" drive; the fp32 parity mode runs at
B=2 against the same port on the CPU.

Each phase prints one JSON line; any failure raises, so the exit code is
non-zero and no result line is printed. TF32 is off for cuDNN convolutions
and matmuls throughout, so every fp32 phase computes in full fp32. Without
a CUDA card, or without the ``ws_mgmap_tpu_torch`` package beside this
file, the script fails.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet (dense): bf16 tensor-core and fp32 CUDA-core peaks,
# HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

EGO, DEPTH_HW, RGB_HW, C = 100, 256, 224, 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for the type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phase 2a: the splat kernel vs its twin
# --------------------------------------------------------------------------
def splat_inputs(b: int, dtype, gen: torch.Generator):
    """Signed features and ids with ~75% invalid pixels; the valid ones
    crowd near the agent like a real frame's."""
    dev = torch.device("cuda")
    p = RGB_HW * RGB_HW
    feats = (torch.randn(b, p, C, generator=gen, device=dev) * 2).to(dtype)
    near = torch.randint(40 * EGO, 60 * EGO, (b, p), generator=gen,
                         device=dev)
    anywhere = torch.randint(0, EGO * EGO, (b, p), generator=gen, device=dev)
    ids = torch.where(torch.rand(b, p, generator=gen, device=dev) < 0.5,
                      near, anywhere)
    invalid = torch.rand(b, p, generator=gen, device=dev) < 0.75
    ids = torch.where(invalid, -1, ids).to(torch.int32).contiguous()
    return feats.contiguous(), ids


def check_splat(ksplat, gen) -> list[dict]:
    rows = []
    for b, dtype in ((6, torch.float32), (6, torch.bfloat16),
                     (24, torch.bfloat16), (13, torch.bfloat16)):
        feats, ids = splat_inputs(b, dtype, gen)
        got = ksplat.splat_max(feats, ids, EGO)
        torch.cuda.synchronize()
        want = ksplat.splat_max_plain(feats, ids, EGO)
        err = float((got - want).abs().max())
        if err != 0.0:
            raise AssertionError(f"splat B={b} {dtype}: max_abs_err {err}, "
                                 "expected exact")
        # the one PyTorch call that computes the scatter-max: amax
        # scatter_reduce_ into a trash-row buffer (fp32 operands prepared)
        idx = torch.where(ids < 0, EGO * EGO, ids).long()[:, :, None].expand(
            b, ids.shape[1], C).contiguous()
        f32 = feats.float()
        buf = torch.empty(b, EGO * EGO + 1, C, device=feats.device)
        lib = cuda_ms(lambda: buf.fill_(float("-inf")).scatter_reduce_(
            1, idx, f32, "amax", include_self=False), 10)
        kern = cuda_ms(lambda: ksplat.splat_max(feats, ids, EGO), 20)
        plain = cuda_ms(lambda: ksplat.splat_max_plain(feats, ids, EGO), 10)
        n_valid = int((ids >= 0).sum())
        nbytes = (n_valid * C * feats.element_size() + ids.numel() * 4
                  + b * EGO * EGO * C * 4)
        rows.append(dict(B=b, dtype=str(dtype).split(".")[-1],
                         valid_share=n_valid / ids.numel(),
                         max_abs_err=err, ms=kern, plain_ms=plain,
                         library_ms=lib,
                         **bound_ms(nbytes, n_valid * C, dtype)))
    return rows


# --------------------------------------------------------------------------
# phase 2b: the fused conv kernel vs its twin, at every fused call site
# --------------------------------------------------------------------------
# (name, H, C1, C2, Co, residual, launches per update_map step) at width 1
CONV_SITES = [
    ("conv_original_size1", 224, 64, 0, 64, False, 1),
    ("conv_original_size2", 224, 128, 64, 64, False, 1),
    ("conv_up0", 112, 256, 64, 128, False, 1),
    ("conv_up1", 56, 256, 64, 256, False, 1),
    ("conv_up2", 28, 512, 128, 256, False, 1),
    ("conv_up3", 14, 512, 256, 512, False, 1),
    ("layer1 conv", 56, 64, 0, 64, False, 2),
    ("layer1 conv+res", 56, 64, 0, 64, True, 2),
    ("layer2 conv", 28, 128, 0, 128, False, 1),
    ("layer2 conv+res", 28, 128, 0, 128, True, 2),
    ("layer3 conv", 14, 256, 0, 256, False, 1),
    ("layer3 conv+res", 14, 256, 0, 256, True, 2),
]
# the kernel and the twin both sum in fp32 in different orders; a bf16
# output may then round one bf16 ulp (2^-7 relative) apart
CONV_TOL = {torch.bfloat16: (2**-7, 1e-3), torch.float32: (1e-4, 1e-4)}


def conv_case(kconv, name, h, c1, c2, co, res, dtype, b, gen):
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale)

    x = rnd(b, h, h, c1).to(dtype)
    x2 = rnd(b, h, h, c2).to(dtype) if c2 else None
    w = rnd(3, 3, c1 + c2, co, scale=(9 * (c1 + c2)) ** -0.5).to(dtype)
    scale = torch.rand(co, generator=gen, device=dev) + 0.5
    bias = rnd(co, scale=0.1)
    residual = rnd(b, h, h, co).to(dtype) if res else None
    got = kconv.conv3x3_bn_relu(x, w, scale, bias, True, residual, x2)
    torch.cuda.synchronize()
    want = kconv.conv3x3_bn_relu_plain(x, w, scale, bias, True, residual, x2)
    diff = (got.float() - want.float()).abs()
    rtol, atol = CONV_TOL[dtype]
    if not bool((diff <= rtol * want.float().abs() + atol).all()):
        raise AssertionError(f"conv {name} {dtype}: max_abs_err "
                             f"{float(diff.max())} beyond rtol {rtol} "
                             f"atol {atol}")

    # library yardstick: cuDNN conv + BN + ReLU (+ residual) in the input
    # dtype, channels_last, over the materialized concat
    def nchw(t):
        return t.permute(0, 3, 1, 2)

    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    mean, var = torch.zeros(co, device=dev), torch.ones(co, device=dev)

    def library():
        xi = nchw(x) if x2 is None else torch.cat([nchw(x), nchw(x2)], 1)
        y = F.batch_norm(F.conv2d(xi, w_oihw, padding=1), mean, var,
                         scale, bias, False, 0.0, 1e-5)
        if residual is not None:
            y = y + nchw(residual)
        return F.relu(y)

    iters = 10 if h >= 112 else 30
    kern = cuda_ms(lambda: kconv.conv3x3_bn_relu(x, w, scale, bias, True,
                                                 residual, x2), iters)
    plain = cuda_ms(lambda: kconv.conv3x3_bn_relu_plain(
        x, w, scale, bias, True, residual, x2), iters)
    lib = cuda_ms(library, iters)
    esz = x.element_size()
    flops = 2.0 * b * h * h * 9 * (c1 + c2) * co
    nbytes = esz * (x.numel() + (0 if x2 is None else x2.numel()) + w.numel()
                    + got.numel() + (0 if residual is None else
                                     residual.numel())) + 8 * co
    return dict(site=name, H=h, C1=c1, C2=c2, Co=co, residual=res, B=b,
                dtype=str(dtype).split(".")[-1],
                max_abs_err=float(diff.max()), tol_rtol_atol=[rtol, atol],
                ms=kern, plain_ms=plain, library_ms=lib, gflop=flops / 1e9,
                **bound_ms(nbytes, flops, dtype))


def check_conv(kconv, gen) -> list[dict]:
    rows = [conv_case(kconv, *site[:6], torch.bfloat16, 6, gen)
            for site in CONV_SITES]
    rows.append(conv_case(kconv, "layer1 conv+res fp32", 56, 64, 0, 64,
                          True, torch.float32, 6, gen))
    return rows


# --------------------------------------------------------------------------
# phases 3 and 4: the map-update step
# --------------------------------------------------------------------------
def occupied(x: torch.Tensor) -> torch.Tensor:
    """Cells whose feature max is above 1e-3 of the map's max (grid_sample
    leaves ~1e-6 weights next to a cell under a near-identity rotation)."""
    m = x.float().amax(-1)
    return m > 1e-3 * float(m.max())


def drive_production(policy, b: int, ksplat, kconv) -> dict:
    """bf16 + rotate-in-splat at batch b: a 15-degree-per-step spin in
    front of the wall with masks=0 at the first and the last step, then a
    timed run of further steps. Every step goes through the kernels."""
    from ws_mgmap_tpu_torch.tools.synthetic import wall_obs
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    eng = RolloutEngine(policy, b, compute_dtype=torch.bfloat16)
    gen = np.random.RandomState(b)
    spin = 6
    obs = [eng.batch_obs(wall_obs(b, math.radians(15 * k), gen))
           for k in range(spin)]
    ksplat.splat_max.launches = 0
    kconv.conv3x3_bn_relu.launches = 0
    counts, first_ego = [], None
    for k in range(spin):
        masks = np.zeros((b, 1)) if k in (0, spin - 1) else np.ones((b, 1))
        ego = eng.update_map(obs[k], masks)
        counts.append(int(occupied(eng.global_map[0]).sum()))
        if k == 0:
            first_ego = ego
    # timed steady state: the same drive, host clock around synchronized
    # steps with the observations already on the card
    warm, timed = 2, 8
    for k in range(warm):
        eng.update_map(obs[k % spin], np.ones((b, 1)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(timed):
        eng.update_map(obs[k % spin], np.ones((b, 1)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed
    launches = {"splat_max": ksplat.splat_max.launches,
                "conv3x3_bn_relu": kconv.conv3x3_bn_relu.launches}
    steps = spin + warm + timed

    # checks: launches, shapes, the wall, the ring, the reset
    if launches["splat_max"] != steps:
        raise AssertionError(f"B={b}: splat launched {launches} times, "
                             f"expected {steps}")
    if launches["conv3x3_bn_relu"] != 16 * steps:
        raise AssertionError(f"B={b}: conv launched {launches} times, "
                             f"expected {16 * steps}")
    if first_ego.shape != (b, EGO, EGO, C) or first_ego.dtype != torch.float32:
        raise AssertionError(f"ego map {first_ego.shape} {first_ego.dtype}")
    if not bool(torch.isfinite(first_ego).all()):
        raise AssertionError("non-finite ego map")
    for i in range(b):  # every env sees the wall: row 49.5 - 3/0.12, 90 deg
        occ = occupied(first_ego[i])
        rows = torch.nonzero(occ.any(1)).flatten().tolist()
        cols = torch.nonzero(occ.any(0)).flatten().tolist()
        wall_row = int(occ.sum(1).argmax())
        if not (23 <= wall_row <= 25 and 22 <= cols[0] <= 26
                and 72 <= cols[-1] <= 76 and rows[-1] - rows[0] <= 2):
            raise AssertionError(f"env {i} wall: row {wall_row}, rows "
                                 f"{rows[0]}-{rows[-1]}, cols {cols[0]}-"
                                 f"{cols[-1]}")
    if not all(counts[k + 1] > counts[k] for k in range(spin - 2)):
        raise AssertionError(f"ring does not accumulate: {counts}")
    if counts[-1] > 1.25 * counts[0]:
        raise AssertionError(f"masks=0 did not clear the map: {counts}")
    return dict(phase="slice", mode="bf16+rotate_in_splat", B=b,
                steps=steps, launches=launches, wall_row=wall_row,
                wall_cols=[cols[0], cols[-1]], ring_cells=counts,
                ms_per_step=ms, frames_per_s=b * 1e3 / ms,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def parity_fp32(policy, ksplat, kconv) -> dict:
    """fp32 parity mode at B=2 on the card vs the same port on the CPU."""
    from ws_mgmap_tpu_torch.tools.synthetic import wall_obs
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    b, steps = 2, 3
    gpu = RolloutEngine(policy, b)
    cpu = RolloutEngine(policy, b, device="cpu")
    gen = np.random.RandomState(7)
    ksplat.splat_max.launches = 0
    kconv.conv3x3_bn_relu.launches = 0
    worst = 0.0
    for k in range(steps):
        raw = wall_obs(b, 0.4 * k - 0.3, gen)
        for i, o in enumerate(raw):
            o["depth"] = (gen.rand(DEPTH_HW, DEPTH_HW, 1) * 0.6).astype(
                np.float32)
            o["gps"] = np.array([0.3 * k, -0.2 * k * i], np.float32)
        masks = np.ones((b, 1))
        if k == 0:
            masks[:] = 0.0  # fresh episodes
        if k == 2:
            masks[0] = 0.0  # env 0 starts a new episode
        ego_g = gpu.update_map(gpu.batch_obs(raw), masks).cpu()
        ego_c = cpu.update_map(cpu.batch_obs(raw), masks)
        glob_g, glob_c = gpu.global_map.cpu(), cpu.global_map
        scale = float(glob_c.abs().max())
        # fp32 on both (TF32 off): sums in other orders and the rotations'
        # fp32 coordinate rounding, well within 1e-3 of the map's range
        for name, g, c_ in (("ego", ego_g, ego_c), ("global", glob_g,
                                                   glob_c)):
            err = float((g - c_).abs().max())
            worst = max(worst, err / scale)
            if err > 1e-3 * scale:
                raise AssertionError(f"fp32 parity step {k} {name}: "
                                     f"{err} vs range {scale}")
    if ksplat.splat_max.launches != steps:
        raise AssertionError(f"fp32: splat launches "
                             f"{ksplat.splat_max.launches} != {steps}")
    if kconv.conv3x3_bn_relu.launches != 0:
        raise AssertionError("fp32 parity mode must keep the library conv")
    return dict(phase="fp32_parity", B=b, steps=steps,
                max_err_over_range=worst,
                launches={"splat_max": ksplat.splat_max.launches,
                          "conv3x3_bn_relu": kconv.conv3x3_bn_relu.launches})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "ws_mgmap_tpu_torch").is_dir():
        print("chip_smoke: the ws_mgmap_tpu_torch package is missing",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ws_mgmap_tpu_torch.ops.kernels import build
    from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
    from ws_mgmap_tpu_torch.ops.kernels import splat as ksplat
    from ws_mgmap_tpu_torch.tools.synthetic import random_policy

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.load_library()
    emit(dict(phase="device", name=torch.cuda.get_device_name(0),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, tf32=False,
              build_s=build.build_seconds,
              load_s=time.perf_counter() - t0))

    # phase 2: kernels vs twins, with times
    gen = torch.Generator(device="cuda").manual_seed(0)
    splat_rows = check_splat(ksplat, gen)
    emit(dict(phase="kernels", kernel="splat_max", cases=splat_rows))
    conv_rows = check_conv(kconv, gen)
    emit(dict(phase="kernels", kernel="conv3x3_bn_relu", cases=conv_rows))

    # phase 3: the slice at full width, production mode
    policy = random_policy(0, rotate_in_splat=True)
    slice_rows = [drive_production(policy, b, ksplat, kconv)
                  for b in (6, 24)]
    for r in slice_rows:
        emit(r)

    # phase 4: fp32 parity mode, card vs CPU
    emit(parity_fp32(random_policy(1, rotate_in_splat=False), ksplat, kconv))

    # the kernels line: launches from the main-path runs of phase 3; times
    # for one B=6 bf16 step (splat once, the 16 fused convs by call site)
    sp = splat_rows[1]
    per_step = {s[0]: s[6] for s in CONV_SITES}
    bf16_conv = [r for r in conv_rows if r["dtype"] == "bfloat16"]

    def conv_sum(key):
        return sum(r[key] * per_step[r["site"]] for r in bf16_conv)

    conv_t = {k: conv_sum(k) for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bytes_ms", "ops_ms")}
    emit({"kernels": [
        {"name": "splat_max", "route": "cuda",
         "source": "ws_mgmap_tpu_torch/ops/kernels/csrc/splat.cu",
         "replaces": "ws_mgmap_tpu/ops/pallas/splat.py:193",
         "launches": sum(r["launches"]["splat_max"] for r in slice_rows),
         "max_abs_err": max(r["max_abs_err"] for r in splat_rows),
         "ms": sp["ms"], "plain_ms": sp["plain_ms"],
         "bound_ms": sp["bound_ms"], "bound_by": sp["bound_by"],
         "library_ms": sp["library_ms"]},
        {"name": "conv3x3_bn_relu", "route": "cuda",
         "source": "ws_mgmap_tpu_torch/ops/kernels/csrc/conv3x3.cu",
         "replaces": "ws_mgmap_tpu/ops/pallas/conv.py:113",
         "launches": sum(r["launches"]["conv3x3_bn_relu"]
                         for r in slice_rows),
         "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
         "ms": conv_t["ms"], "plain_ms": conv_t["plain_ms"],
         "bound_ms": conv_t["bound_ms"],
         "bound_by": ("operations" if conv_t["ops_ms"] >= conv_t["bytes_ms"]
                      else "bytes"),
         "library_ms": conv_t["library_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
