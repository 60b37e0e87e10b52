#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py [--sweep-tiles] [--splat-ablation]

Builds the port's CUDA kernels from ``ws_mgmap_tpu_torch/ops/kernels/csrc``
(into ``build/ws_mgmap_tpu_torch/``), holds each kernel against its plain
PyTorch twin at the main path's shapes and times both (the splat on
synthetic ids, on the ids of a B=6 and a B=24 step
of the wall spin, and untimed on edge values: NaN, infinities, signed
zeros; the fused conv's wgmma kernel at every call site at B=6 and B=24,
the UNet's 16 and the map decoder's 4, and its direct kernel at an fp32
and a ragged-channel shape; with ``--sweep-tiles`` also the wgmma kernel
with every tile; with ``--splat-ablation`` also variants of the splat
with a part taken out), then drives the whole policy at full width with
random weights from a seed: the map-update step
(``RolloutEngine.update_map``: the ResNet18-UNet over 224^2 RGB, 256^2
depth, 100^2 ego and 240^2 global maps) and the decision path
(``RolloutEngine.act`` every third step: the UNet and the mapping step,
the depth ResNet50, the map encoder / decoder / classifier, the
instruction biLSTM once per episode, attention, the two GRUs and the
heads). Production mode (bf16 + rotate-in-splat) runs at B=6 and B=24 on
a "wall 3 m ahead" drive; the fp32 parity mode runs act and update_map at
B=2 against the same port on the CPU. Last, the teacher-forcing training
step (``train/step.py``: ``forward_seq`` over 5 episodes x 64 steps, the
losses, backward, Adam with frozen trunks, train-mode BatchNorm) runs in
fp32 at full width, launching none of the kernels, timed with remat off
and on; one update at N=2, T=4 is held against the CPU, and a bf16 rollout
engine built from the trained weights acts once. Phase 6, data-parallel
teacher forcing fed from the replay store: the training cell's episodes
are written to a store with the port's writer (its backend printed) and
read back through ``ReplayLoader``; in a one-rank NCCL group the
data-parallel update (``make_train_step(distributed=True)``: global
BatchNorm statistics and loss normalisers, one gradient all-reduce)
matches the plain update from the same weights, and both are timed with
the all-reduces counted; then ranks in subprocesses
(``ws_mgmap_tpu_torch/tools/dist_train_check.py``), each fed its shard
through its loader, match one process on the concatenated batch with
bit-identical parameters: NCCL on up to 4 cards (then timed at N=5,
T=200 per rank), or, on one card, two gloo ranks sharing it. No kernel
launches in phase 6. Phase 7, checkpoint evaluation on FakeSim: the
config tree from the port's ``CMA_AUG.yaml`` (its own YAML reader), the
FakeSim split, forkserver env workers (none may hold a CUDA context) and
``evaluate`` over the card's ``RolloutEngine``: the production run (bf16
+ rotate-in-splat, 5 workers holding 1 to 5 of 15 episodes of at most
72 steps, so that envs pause and the batch falls from 5 to 1; every
episode ends, JAX's metric keys finite, both metric JSONs written; wall
time, episodes/s, env steps/s, a loop step split into the env step,
batch_obs, act and update_map, peak memory, the splat and wgmma launches);
an fp32 run at B=2 where a CPU engine with the same weights gets the same
batches and masks in lockstep (each decision's waypoint and prog, each
step's ego and global map within 1e-3 of the range); a ``use_ddppo`` run
with the DD-PPO controller on the CPU in 2 workers; and the controller's
``act`` on the card against the CPU at B=4. Phase 8, training,
evaluation and inference through the port's command line
(``ws_mgmap_tpu_torch/run.py``, in this process): ``FAKESIM_DEBUG.yaml``
at full width with bf16 rollouts, two DAgger iterations (beta 1, then
0.75) of collection into the store and teacher-forcing epochs, eval
while training, the checkpoint folder's evaluation and inference; the
store read back, each checkpoint loading strictly, no eval-while-training
failure, every metric finite, each inference episode recorded once, and
exactly 1 splat per engine step, 16 wgmma per map-update step and 20 per
act step, none in the updates. Phase 9, the last modules: an evaluation
with ``VIDEO_OPTION ["disk"]`` (3 env workers holding 1, 2 and 3 of 6
episodes of at most 36 steps, bf16, ``VIDEO_NUM`` 4, the semantic sensors
a video eval adds: 4 PNG directories of a frame a step in the JAX
compositor's shape, each PNG decoding to the frame written, the panels
changing, exact launches; compositor and writer timed, zlib 1 against 6)
paired with the same evaluation without videos; one bf16 engine against
the same engine split over every card (two replicas on ``cuda:0`` where
there is one card) through two map-update steps, an act and ``keep`` to
5 and to 4 envs, within ``SPLIT_TOL``, launching once a chunk, both
timed; and ``SIMULATOR.TYPE "Sim-v0"`` raising ``ImportError`` without
habitat-sim. Every batch and dtype that phases 7-9 run the kernels at
must be one that phase 2 held them at.

Each phase prints one JSON line; any failure raises, so the exit code is
non-zero and no result line is printed. TF32 is off for cuDNN convolutions
and matmuls throughout, so every fp32 phase computes in full fp32. Without
a CUDA card, or without the ``ws_mgmap_tpu_torch`` package beside this
file, the script fails.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import json
import math
import os
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
# GPU clocks per second at the H100's highest SM clock: a sleep of this
# many cycles lasts at least a second
SLEEP_CYCLES_PER_S = 1.98e9

EGO, DEPTH_HW, RGB_HW, C = 100, 256, 224, 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2, reps: int = 3
            ) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``. The device time is the
    median of ``reps`` readings, each from CUDA events around ``iters``
    back-to-back calls while the stream is held (``torch.cuda._sleep``)
    until the host has enqueued them all, so the host's launch cost is not
    counted in it; the host time is what enqueueing one call costs the
    Python thread."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    readings = []
    for _ in range(reps):
        torch.cuda._sleep(int((1.5 * enqueue_s + 1e-3) * SLEEP_CYCLES_PER_S))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end) / iters)
    return float(np.median(readings)), enqueue_s * 1e3 / iters


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


def splat_exact(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Exact equality with NaN in the same places; the max abs error (0)."""
    nan = torch.isnan(want)
    same = (got == want) | (nan & torch.isnan(got))
    err = float(torch.where(same, 0.0, (got - want).abs()).max())
    if not bool(same.all()):
        raise AssertionError(f"splat {what}: max_abs_err {err} or NaN "
                             "elsewhere, expected exact")
    return err


def wall_spin_splat_inputs(policy, b: int) -> tuple:
    """The feats and ids that one production step of the wall spin hands
    to ``splat_max`` (captured from ``project_egocentric``)."""
    from ws_mgmap_tpu_torch.ops import projection
    from ws_mgmap_tpu_torch.tools.synthetic import wall_obs
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    eng = RolloutEngine(policy, b, compute_dtype=torch.bfloat16)
    obs = eng.batch_obs(wall_obs(b, math.radians(30), np.random.RandomState(b)))
    seen, real = [], projection.splat_max

    def capture(feats, ids, ego_size):
        seen.append((feats.clone(), ids.clone()))
        return real(feats, ids, ego_size)

    projection.splat_max = capture
    try:
        eng.update_map(obs, np.zeros((b, 1)))
    finally:
        projection.splat_max = real
    if len(seen) != 1:
        raise AssertionError(f"one step splatted {len(seen)} times")
    return seen[0]


def splat_case(ksplat, name: str, feats, ids, timed: bool = True) -> dict:
    """The kernel vs the twin (exact, NaN-aware), its cluster plan, then
    the device times of the kernel, the twin and scatter_reduce_."""
    b, p, c = feats.shape
    got = ksplat.splat_max(feats, ids, EGO)
    torch.cuda.synchronize()
    err = splat_exact(got, ksplat.splat_max_plain(feats, ids, EGO), name)
    plan = ksplat.splat_plan(EGO, c)
    smem = ksplat.splat_smem_bytes(plan)
    if smem != plan.smem_bytes:
        raise AssertionError(f"splat plan: {plan.smem_bytes} bytes of shared "
                             f"memory planned, the kernel takes {smem}")
    row = dict(case=name, B=b, dtype=str(feats.dtype).split(".")[-1],
               valid_share=float((ids >= 0).float().mean()),
               max_abs_err=err, ranks=ksplat.RANKS, groups=plan.n_groups,
               group=plan.group, smem_bytes=smem,
               max_active_clusters=ksplat.splat_active_clusters(feats, ids,
                                                                EGO))
    if not timed:
        return row
    # the one PyTorch call that computes the scatter-max: amax
    # scatter_reduce_ into a trash-row buffer (fp32 operands prepared)
    idx = torch.where(ids < 0, EGO * EGO, ids).long()[:, :, None].expand(
        b, p, c).contiguous()
    f32 = feats.float()
    buf = torch.empty(b, EGO * EGO + 1, c, device=feats.device)
    lib, _ = cuda_ms(lambda: buf.fill_(float("-inf")).scatter_reduce_(
        1, idx, f32, "amax", include_self=False), 10)
    kern, host = cuda_ms(lambda: ksplat.splat_max(feats, ids, EGO), 20)
    plain, _ = cuda_ms(lambda: ksplat.splat_max_plain(feats, ids, EGO), 10)
    n_valid = int((ids >= 0).sum())
    nbytes = (n_valid * c * feats.element_size() + ids.numel() * 4
              + b * EGO * EGO * c * 4)
    return dict(row, ms=kern, host_ms=host, plain_ms=plain, library_ms=lib,
                **bound_ms(nbytes, n_valid * c, feats.dtype))


def check_splat(ksplat, gen, policy) -> list[dict]:
    """Five timed synthetic cases (the last at the production eval's
    batch), untimed ones at the other batches of phase 7 (bf16 at 1-4 as
    its envs pause, fp32 at 1-2 for its lockstep run), the B=6 and B=24
    steps of the wall spin, and edge values (NaN, infinities, signed
    zeros, maxima <= -1e16)."""
    from ws_mgmap_tpu_torch.tools.synthetic import special_splat_inputs

    rows = []
    for b, dtype in ((6, torch.float32), (6, torch.bfloat16),
                     (24, torch.bfloat16), (13, torch.bfloat16),
                     (EVAL_PROCESSES, torch.bfloat16)):
        feats, ids = splat_inputs(b, dtype, gen)
        rows.append(splat_case(ksplat, "synthetic", feats, ids))
    for b, dtype in ([(b, torch.bfloat16) for b in EVAL_B[:-1]]
                     + [(1, torch.float32), (2, torch.float32)]):
        feats, ids = splat_inputs(b, dtype, gen)
        rows.append(splat_case(ksplat, "synthetic, eval batch", feats, ids,
                               timed=False))
    for b in PRODUCTION_B:
        feats, ids = wall_spin_splat_inputs(policy, b)
        rows.append(splat_case(ksplat, "wall spin", feats, ids))
    feats, ids = special_splat_inputs(np.random.RandomState(3),
                                      RGB_HW * RGB_HW, C, EGO)
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(splat_case(
            ksplat, "edge values", torch.from_numpy(feats).cuda().to(dtype),
            torch.from_numpy(ids).cuda(), timed=False))
    return rows


# (name, [(text in csrc/splat.cu, its replacement)]): each variant takes a
# part of the kernel out, computes a wrong result and is only timed
SPLAT_ABLATIONS = [
    # every atomic into the block's own keys, none over the cluster
    ("local atomics", [("cg::this_cluster().map_shared_rank(keys, id % kRanks)",
                        "keys")]),
    # a plain store into the block's own keys in place of each atomic
    ("plain stores", [(
        "  uint32_t* dst = cg::this_cluster().map_shared_rank(keys, id % kRanks);\n"
        "  atomicMax(dst + (id / kRanks) * group + lane, run);\n",
        "  keys[(id / kRanks) * group + lane] = run;\n")]),
    # no merge: zero, list, cluster barriers and the output write only
    ("no merge", [("      merge_list<T>(list, n, fid, fg, C, gw, aligned, "
                   "group, stage, keys);\n", "")]),
]


def splat_ablation_sources(src: str) -> dict:
    """Each ablation's source: ``src`` with its replacements, each of which
    must match exactly once."""
    out = {}
    for name, edits in SPLAT_ABLATIONS:
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"splat ablation {name!r}: {old!r} "
                                     f"found {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def splat_ablation(ksplat, build, gen, policy) -> list[dict]:
    """The splat and its ablations (one library each, built under
    ``build/``: one nvcc per variant, all started together) timed on the
    B=6 and B=24 bf16 synthetic and wall-spin inputs, the kernel first and
    last."""
    out_dir = build.BUILD_ROOT / "splat_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in splat_ablation_sources(
            (build.CSRC / "splat.cu").read_text()).items():
        stem = name.replace(" ", "_")
        (out_dir / f"{stem}.cu").write_text(text)
        lib = out_dir / f"lib{stem}.so"
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-shared", "-o", str(lib), str(out_dir / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"splat ablation {name!r}: nvcc failed:\n{log}")
        fns[name] = ctypes.CDLL(str(lib)).ws_splat_max
        fns[name].argtypes, fns[name].restype = build.SIGNATURES["ws_splat_max"]
    cases = [("synthetic", *splat_inputs(b, torch.bfloat16, gen))
             for b in PRODUCTION_B]
    cases += [("wall spin", *wall_spin_splat_inputs(policy, b))
              for b in PRODUCTION_B]
    rows = []
    for case, feats, ids in cases:
        b, p, c = feats.shape
        plan = ksplat.splat_plan(EGO, c)
        out = torch.empty(b, EGO, EGO, c, device=feats.device)

        def call(fn):
            status = fn(feats.data_ptr(), ids.data_ptr(), out.data_ptr(), b,
                        p, c, EGO * EGO, plan.cells_per_rank, plan.group,
                        int(feats.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"splat ablation: CUDA error {status}")

        row = dict(phase="splat_ablation", case=case, B=b,
                   dtype=str(feats.dtype).split(".")[-1])
        row["kernel_ms"] = cuda_ms(lambda: ksplat.splat_max(feats, ids, EGO),
                                   20)[0]
        for name, fn in fns.items():
            row[f"{name}_ms"] = cuda_ms(lambda fn=fn: call(fn), 20)[0]
        row["kernel_again_ms"] = cuda_ms(
            lambda: ksplat.splat_max(feats, ids, EGO), 20)[0]
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# phase 2b: the fused conv kernel vs its twin, at every fused call site
# --------------------------------------------------------------------------
# (name, H, C1, C2, Co, residual, launches per update_map step, launches
# per act step) at width 1: the UNet's sites run on both steps, the map
# decoder's only on the act step (its 6x6 BasicBlocks stay unfused, as in
# the JAX package)
CONV_SITES = [
    ("conv_original_size1", 224, 64, 0, 64, False, 1, 1),
    ("conv_original_size2", 224, 128, 64, 64, False, 1, 1),
    ("conv_up0", 112, 256, 64, 128, False, 1, 1),
    ("conv_up1", 56, 256, 64, 256, False, 1, 1),
    ("conv_up2", 28, 512, 128, 256, False, 1, 1),
    ("conv_up3", 14, 512, 256, 512, False, 1, 1),
    ("layer1 conv", 56, 64, 0, 64, False, 2, 2),
    ("layer1 conv+res", 56, 64, 0, 64, True, 2, 2),
    ("layer2 conv", 28, 128, 0, 128, False, 1, 1),
    ("layer2 conv+res", 28, 128, 0, 128, True, 2, 2),
    ("layer3 conv", 14, 256, 0, 256, False, 1, 1),
    ("layer3 conv+res", 14, 256, 0, 256, True, 2, 2),
    ("map_decoder.conv_original_size0", 24, 256, 0, 64, False, 0, 1),
    ("map_decoder.conv_original_size1", 24, 64, 0, 64, False, 0, 1),
    ("map_decoder.conv_up0", 12, 64, 64, 128, False, 0, 1),
    ("map_decoder.conv_original_size2", 24, 128, 64, 64, False, 0, 1),
]
STEP_KINDS = ("update_map", "act")  # CONV_SITES' launch columns, in order
CONV_PER_STEP = {"update_map": 16, "act": 20}
# the kernel and the twin both sum in fp32 in different orders; a bf16
# output may then round one bf16 ulp (2^-7 relative) apart
CONV_TOL = {torch.bfloat16: (2**-7, 1e-3), torch.float32: (1e-4, 1e-4)}
PRODUCTION_B = (6, 24)  # the production drives' batches
EVAL_PROCESSES = 5  # the production eval's env workers, its first batch
# phase 7's batches: its envs pause one by one (checked, the last timed)
EVAL_B = tuple(range(1, EVAL_PROCESSES + 1))
CONV_B = PRODUCTION_B + (EVAL_PROCESSES,)  # the timed batches


def conv_launches(kconv) -> dict:
    return {"conv_wgmma": kconv.conv3x3_bn_relu_wgmma.launches,
            "conv_direct": kconv.conv3x3_bn_relu_direct.launches}


def conv_operands(h, c1, c2, co, res, dtype, b, gen):
    """Random operands of one call site: x, x2, HWIO w, scale, bias,
    residual (x2 and residual None where the site has none)."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale)

    x = rnd(b, h, h, c1).to(dtype)
    x2 = rnd(b, h, h, c2).to(dtype) if c2 else None
    w = rnd(3, 3, c1 + c2, co, scale=(9 * (c1 + c2)) ** -0.5).to(dtype)
    scale = torch.rand(co, generator=gen, device=dev) + 0.5
    bias = rnd(co, scale=0.1)
    residual = rnd(b, h, h, co).to(dtype) if res else None
    return x, x2, w, scale, bias, residual


def cudnn_call(x, x2, w, scale, bias, residual):
    """The library yardstick: cuDNN conv + BN + ReLU (+ residual) in the
    input dtype, channels_last, over the materialized concat."""
    def nchw(t):
        return t.permute(0, 3, 1, 2)

    co = w.shape[-1]
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    mean = torch.zeros(co, device=x.device)
    var = torch.ones(co, device=x.device)

    def library():
        xi = nchw(x) if x2 is None else torch.cat([nchw(x), nchw(x2)], 1)
        y = F.batch_norm(F.conv2d(xi, w_oihw, padding=1), mean, var,
                         scale, bias, False, 0.0, 1e-5)
        if residual is not None:
            y = y + nchw(residual)
        return F.relu(y)

    return library


def conv_case(kconv, name, h, c1, c2, co, res, dtype, b, gen,
              timed: bool = True):
    """One call site: the kernel that the dispatch picks vs the twin (and
    which kernel it was), then, if ``timed``, the times of that kernel
    (weights in its own layout, as the UNet passes them), the twin, cuDNN,
    and at bf16 the direct kernel too."""
    x, x2, w, scale, bias, residual = conv_operands(h, c1, c2, co, res,
                                                    dtype, b, gen)
    variant = kconv.conv_variant(dtype, c1, c2, co)
    before = conv_launches(kconv)
    got = kconv.conv3x3_bn_relu(x, w, scale, bias, True, residual, x2)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in conv_launches(kconv).items()}
    if ran != {"conv_wgmma": int(variant == "wgmma"),
               "conv_direct": int(variant == "direct")}:
        raise AssertionError(f"conv {name} B={b}: {variant} expected, ran "
                             f"{ran}")
    want = kconv.conv3x3_bn_relu_plain(x, w, scale, bias, True, residual, x2)
    diff = (got.float() - want.float()).abs()
    rtol, atol = CONV_TOL[dtype]
    if not bool((diff <= rtol * want.float().abs() + atol).all()):
        raise AssertionError(f"conv {name} B={b} {dtype}: max_abs_err "
                             f"{float(diff.max())} beyond rtol {rtol} "
                             f"atol {atol}")
    row = dict(site=name, H=h, C1=c1, C2=c2, Co=co, residual=res, B=b,
               dtype=str(dtype).split(".")[-1], variant=variant,
               max_abs_err=float(diff.max()), tol_rtol_atol=[rtol, atol])
    if variant == "wgmma":
        grid = kconv.wgmma_grid(b, h, h, c1 + c2, co)
        row.update(tile_th_bn=list(kconv.wgmma_tile(b, h, h, c1 + c2, co)),
                   grid=list(grid), blocks=math.prod(grid))
    if not timed:
        return row

    iters = 10 if h >= 112 else 30
    wk = kconv.kernel_weight(w, variant)
    kern, host = cuda_ms(lambda: kconv.KERNELS[variant](
        x, wk, scale, bias, True, residual, x2), iters)
    plain, _ = cuda_ms(lambda: kconv.conv3x3_bn_relu_plain(
        x, w, scale, bias, True, residual, x2), iters)
    lib, _ = cuda_ms(cudnn_call(x, x2, w, scale, bias, residual), iters)
    extra = {}
    if variant == "wgmma":  # the direct kernel on the same call, for scale
        extra = dict(
            direct_ms=cuda_ms(lambda: kconv.conv3x3_bn_relu_direct(
                x, w, scale, bias, True, residual, x2), iters)[0],
            # wgmma_tile's branch: below MIN_BLOCKS no tile keeps two
            # thirds of the SMs busy, and the one with the most blocks wins
            tile_rule=("fewest L2 bytes"
                       if row["blocks"] >= kconv.MIN_BLOCKS
                       else "most blocks"))
    esz = x.element_size()
    flops = 2.0 * b * h * h * 9 * (c1 + c2) * co
    nbytes = esz * (x.numel() + (0 if x2 is None else x2.numel()) + w.numel()
                    + got.numel() + (0 if residual is None else
                                     residual.numel())) + 8 * co
    bound = bound_ms(nbytes, flops, dtype)
    return dict(row, ms=kern, host_ms=host, plain_ms=plain, library_ms=lib,
                gflop=flops / 1e9,
                tflops=flops / kern / 1e9,
                share_of_bound=bound["bound_ms"] / kern, **extra, **bound)


def check_conv(kconv, gen) -> list[dict]:
    """The wgmma kernel at every call site at both production batches and
    the production eval's first (its tile, and so its template instance
    and grid, depends on the batch), untimed at phase 7's other batches,
    the direct kernel at an fp32 and a ragged-channel shape."""
    rows = [conv_case(kconv, *site[:6], torch.bfloat16, b, gen)
            for b in CONV_B for site in CONV_SITES]
    rows += [conv_case(kconv, *site[:6], torch.bfloat16, b, gen, timed=False)
             for b in EVAL_B if b not in CONV_B for site in CONV_SITES]
    rows.append(conv_case(kconv, "layer1 conv+res fp32", 56, 64, 0, 64,
                          True, torch.float32, 6, gen))
    rows.append(conv_case(kconv, "ragged 96+32->70 bf16", 28, 96, 32, 70,
                          False, torch.bfloat16, 6, gen))
    return rows


def conv_per_step(rows: list[dict], b: int, step: str) -> dict:
    """The fused calls of one bf16 ``step`` ("update_map": 16, "act": 20)
    at batch b, summed by call site."""
    col = 6 + STEP_KINDS.index(step)
    per_step = {s[0]: s[col] for s in CONV_SITES if s[col]}
    if sum(per_step.values()) != CONV_PER_STEP[step]:
        raise AssertionError(f"CONV_SITES: {per_step} for one {step} step")
    sites = [r for r in rows if r["B"] == b and r["dtype"] == "bfloat16"
             and r["site"] in per_step]
    t = {k: sum(r[k] * per_step[r["site"]] for r in sites)
         for k in ("ms", "host_ms", "direct_ms", "plain_ms", "library_ms",
                   "bound_ms", "bytes_ms", "ops_ms")}
    return dict(phase="conv_per_step", step=step, B=b,
                calls=CONV_PER_STEP[step], dtype="bfloat16", **t,
                below_library=t["ms"] < t["library_ms"],
                sites_slower_than_library=[r["site"] for r in sites
                                           if r["ms"] > r["library_ms"]])


def sweep_tiles(kconv, gen) -> list[dict]:
    """(``--sweep-tiles``) The wgmma kernel's device ms with each tile of
    ``WGMMA_TILES`` no wider than Co, at every distinct call site and
    production batch, beside cuDNN's ms and the tile that ``wgmma_tile``
    picks."""
    rows, seen = [], set()
    for b in PRODUCTION_B:
        for name, h, c1, c2, co, res, *_ in CONV_SITES:
            if (b, h, c1, c2, co, res) in seen:
                continue
            seen.add((b, h, c1, c2, co, res))
            x, x2, w, scale, bias, r = conv_operands(
                h, c1, c2, co, res, torch.bfloat16, b, gen)
            wp = kconv.pack_weight(w)
            times = {str(t): cuda_ms(
                lambda t=t: kconv.conv3x3_bn_relu_wgmma(
                    x, wp, scale, bias, True, r, x2, tile=t), 20)[0]
                for t in kconv.WGMMA_TILES if t[1] <= max(co, 64)}
            rows.append(dict(
                phase="sweep_tiles", B=b, site=name,
                library_ms=cuda_ms(cudnn_call(x, x2, w, scale, bias, r),
                                   20)[0],
                pick=str(kconv.wgmma_tile(b, h, h, c1 + c2, co)),
                ms_by_tile=times))
    return rows


# --------------------------------------------------------------------------
# phases 3 and 4: the map-update step
# --------------------------------------------------------------------------
def occupied(x: torch.Tensor) -> torch.Tensor:
    """Cells whose feature max is above 1e-3 of the map's max (grid_sample
    leaves ~1e-6 weights next to a cell under a near-identity rotation)."""
    m = x.float().amax(-1)
    return m > 1e-3 * float(m.max())


def check_wall(ego: torch.Tensor, b: int) -> tuple[int, list[int]]:
    """The first step's fp32 ego map [b, 100, 100, 64] of the wall spin:
    finite, and every env sees the wall 3 m ahead (row 49.5 - 3/0.12)
    across the 90-degree field of view. Returns the last env's wall row and
    first and last columns."""
    if ego.shape != (b, EGO, EGO, C) or ego.dtype != torch.float32:
        raise AssertionError(f"ego map {ego.shape} {ego.dtype}")
    if not bool(torch.isfinite(ego).all()):
        raise AssertionError("non-finite ego map")
    for i in range(b):
        occ = occupied(ego[i])
        rows = torch.nonzero(occ.any(1)).flatten().tolist()
        cols = torch.nonzero(occ.any(0)).flatten().tolist()
        wall_row = int(occ.sum(1).argmax())
        if not (23 <= wall_row <= 25 and 22 <= cols[0] <= 26
                and 72 <= cols[-1] <= 76 and rows[-1] - rows[0] <= 2):
            raise AssertionError(f"env {i} wall: row {wall_row}, rows "
                                 f"{rows[0]}-{rows[-1]}, cols {cols[0]}-"
                                 f"{cols[-1]}")
    return wall_row, [cols[0], cols[-1]]


def reset_launches(ksplat, kconv) -> None:
    ksplat.splat_max.launches = 0
    kconv.conv3x3_bn_relu_wgmma.launches = 0
    kconv.conv3x3_bn_relu_direct.launches = 0


def launch_counts(ksplat, kconv) -> dict:
    return {"splat_max": ksplat.splat_max.launches, **conv_launches(kconv)}


def host_ms(fn, rounds: int, per_round: int) -> tuple[float, list[float]]:
    """Median and range of the host-clock ms per call of ``fn`` over
    synchronized rounds of ``per_round`` calls."""
    round_ms = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_round):
            fn()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3 / per_round)
    return float(np.median(round_ms)), [min(round_ms), max(round_ms)]


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
    reset_launches(ksplat, kconv)
    counts, first_ego = [], None
    for k in range(spin):
        masks = np.zeros((b, 1)) if k in (0, spin - 1) else np.ones((b, 1))
        ego = eng.update_map(obs[k], masks)
        counts.append(int(occupied(eng.global_map[0]).sum()))
        if k == 0:
            first_ego = ego
    # timed steady state: the same drive, host clock around synchronized
    # rounds of steps with the observations already on the card; the step
    # is the host's and spreads, so the median round and the range
    warm, rounds, per_round = 2, 5, 8
    for k in range(warm):
        eng.update_map(obs[k % spin], np.ones((b, 1)))
    seq = iter(range(rounds * per_round))
    ms, ms_range = host_ms(lambda: eng.update_map(obs[next(seq) % spin],
                                                  np.ones((b, 1))),
                           rounds, per_round)
    launches = launch_counts(ksplat, kconv)
    steps = spin + warm + rounds * per_round

    # checks: launches, shapes, the wall, the ring, the reset
    if launches["splat_max"] != steps:
        raise AssertionError(f"B={b}: splat launched {launches} times, "
                             f"expected {steps}")
    if launches["conv_wgmma"] != 16 * steps or launches["conv_direct"]:
        raise AssertionError(f"B={b}: conv launches {launches}, expected "
                             f"{16 * steps} wgmma and 0 direct")
    wall_row, cols = check_wall(first_ego, b)
    if not all(counts[k + 1] > counts[k] for k in range(spin - 2)):
        raise AssertionError(f"ring does not accumulate: {counts}")
    if counts[-1] > 1.25 * counts[0]:
        raise AssertionError(f"masks=0 did not clear the map: {counts}")
    return dict(phase="slice", mode="bf16+rotate_in_splat", B=b,
                steps=steps, launches=launches, wall_row=wall_row,
                wall_cols=cols, ring_cells=counts,
                ms_per_step=ms, ms_per_step_range=ms_range,
                frames_per_s=b * 1e3 / ms,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def drive_act(policy, b: int, ksplat, kconv) -> dict:
    """The decision path in bf16 + rotate-in-splat at batch b, at the
    reference cadence (act, update_map, update_map) on the wall spin, 15
    degrees a step: masks=0 at the first step; at the third act the first
    half of the envs start new episodes with new instructions (the text
    cache re-encodes); one ``zero_hidden_at`` after the second act. Every
    step's launches are checked (act: 1 splat, 20 wgmma, 0 direct;
    update_map: 1, 16, 0), then act, the decision cycle and encode_text
    are timed."""
    from ws_mgmap_tpu_torch.tools.synthetic import (instruction_tokens,
                                                    wall_obs)
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    torch.cuda.reset_peak_memory_stats()
    eng = RolloutEngine(policy, b, compute_dtype=torch.bfloat16)
    gen = np.random.RandomState(100 + b)
    tok0 = instruction_tokens(b, gen)
    tok1 = tok0.copy()
    tok1[: b // 2] = instruction_tokens(b // 2, gen)
    cycles, new_episode, zeroed = 4, 2, b - 1
    obs = [eng.batch_obs(wall_obs(b, math.radians(15 * k), gen,
                                  tokens=tok1 if k >= 3 * new_episode
                                  else tok0))
           for k in range(3 * cycles)]
    encodes = []
    real_encode = eng.policy.encode_text

    def counted_encode(tokens):
        encodes.append(tokens.shape)
        return real_encode(tokens)

    eng.policy.encode_text = counted_encode
    want = {"act": {"splat_max": 1, "conv_wgmma": 20, "conv_direct": 0},
            "update_map": {"splat_max": 1, "conv_wgmma": 16,
                           "conv_direct": 0}}
    reset_launches(ksplat, kconv)
    first, prev_hidden = None, None
    for k in range(3 * cycles):
        masks = np.ones((b, 1))
        if k == 0:
            masks[:] = 0.0
        if k == 3 * new_episode:
            masks[: b // 2] = 0.0
        before = launch_counts(ksplat, kconv)
        if k % 3:
            eng.update_map(obs[k], masks)
            kind = "update_map"
        else:
            out = eng.act(obs[k], masks)
            kind = "act"
            for name in ("action", "value", "prog", "hidden"):
                if not bool(torch.isfinite(getattr(out, name)).all()):
                    raise AssertionError(f"B={b} step {k}: non-finite "
                                         f"{name}")
            if tuple(out.pred_sem_map.shape) != (b, 48, 48, 27):
                raise AssertionError(f"B={b}: pred_sem_map "
                                     f"{tuple(out.pred_sem_map.shape)}")
            if prev_hidden is not None and torch.equal(prev_hidden,
                                                       out.hidden):
                raise AssertionError(f"B={b} step {k}: hidden unchanged")
            if k == 0:
                first = out
            if k == 3:
                eng.zero_hidden_at(zeroed)
                if bool(eng.hidden[:, zeroed].any()) or not bool(
                        eng.hidden[:, :zeroed].any()):
                    raise AssertionError(f"B={b}: zero_hidden_at({zeroed})")
            prev_hidden = eng.hidden
        ran = {key: v - before[key]
               for key, v in launch_counts(ksplat, kconv).items()}
        if ran != want[kind]:
            raise AssertionError(f"B={b} step {k} ({kind}): launches {ran}, "
                                 f"expected {want[kind]}")
    if len(encodes) != 2:
        raise AssertionError(f"B={b}: encode_text ran {len(encodes)} times "
                             "for 2 token batches")
    wall_row, cols = check_wall(first.ego_map, b)
    steps = {"act": cycles, "update_map": 2 * cycles}

    # timed: rounds of acts, then of decision cycles, on the last cycle's
    # observations (its tokens are cached, so the biLSTM does not run)
    ones = np.ones((b, 1))
    last = obs[-3:]
    warm, rounds, per_round = 2, 5, 8
    for _ in range(warm):
        eng.act(last[0], ones)
    act_ms, act_range = host_ms(lambda: eng.act(last[0], ones), rounds,
                                per_round)

    def cycle():
        eng.act(last[0], ones)
        eng.update_map(last[1], ones)
        eng.update_map(last[2], ones)

    cycle_ms, cycle_range = host_ms(cycle, rounds, per_round)
    steps["act"] += warm + 2 * rounds * per_round
    steps["update_map"] += 2 * rounds * per_round
    launches = launch_counts(ksplat, kconv)
    expect = {key: sum(want[kind][key] * n for kind, n in steps.items())
              for key in launches}
    if launches != expect or len(encodes) != 2:
        raise AssertionError(f"B={b}: launches {launches}, expected "
                             f"{expect}; {len(encodes)} text encodes")
    # as the engine calls it: the tokens on the host, the biLSTM stepping
    # to the longest row
    tok = obs[-1]["instruction"]
    text_ms, text_range = host_ms(lambda: real_encode(tok), 5, 1)
    return dict(phase="act_drive", mode="bf16+rotate_in_splat", B=b,
                steps=steps, launches=launches,
                launches_per_step=want, text_encodes=len(encodes),
                wall_row=wall_row, wall_cols=cols,
                act_ms=act_ms, act_ms_range=act_range,
                act_frames_per_s=b * 1e3 / act_ms,
                cycle_ms=cycle_ms, cycle_ms_range=cycle_range,
                encode_text_ms=text_ms, encode_text_ms_range=text_range,
                encode_text_steps=int((tok != 0).sum(1).max()),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def parity_fp32(policy, ksplat, kconv) -> dict:
    """fp32 parity mode at B=2 on the card vs the same port on the CPU,
    over act, update_map, update_map, act: the maps at every step, and at
    each act the waypoint, value, hidden state, semantic logits and
    attention weights, each within 1e-3 of its range on the CPU."""
    from ws_mgmap_tpu_torch.tools.synthetic import wall_obs
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    b, steps = 2, 4
    gpu = RolloutEngine(policy, b)
    cpu = RolloutEngine(policy, b, device="cpu")
    gen = np.random.RandomState(7)
    reset_launches(ksplat, kconv)
    worst: dict[str, float] = {}

    def hold(k, name, got, want):
        # fp32 on both (TF32 off): sums in other orders and the rotations'
        # fp32 coordinate rounding, well within 1e-3 of the range
        scale = float(want.abs().max())
        err = float((got.cpu() - want).abs().max())
        worst[name] = max(worst.get(name, 0.0), err / scale)
        if not err <= 1e-3 * scale:
            raise AssertionError(f"fp32 parity step {k} {name}: {err} vs "
                                 f"range {scale}")

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
        if k % 3:
            hold(k, "ego_map", gpu.update_map(gpu.batch_obs(raw), masks),
                 cpu.update_map(cpu.batch_obs(raw), masks))
        else:
            og = gpu.act(gpu.batch_obs(raw), masks)
            oc = cpu.act(cpu.batch_obs(raw), masks)
            for name in ("action", "value", "hidden", "pred_sem_map",
                         "att_map", "ego_map"):
                hold(k, name, getattr(og, name), getattr(oc, name))
        hold(k, "global_map", gpu.global_map, cpu.global_map)
    launches = launch_counts(ksplat, kconv)
    if launches["splat_max"] != steps:
        raise AssertionError(f"fp32: splat launches {launches['splat_max']}"
                             f" != {steps}")
    if launches["conv_wgmma"] or launches["conv_direct"]:
        raise AssertionError(f"fp32 parity mode must keep the library conv: "
                             f"{launches}")
    return dict(phase="fp32_parity", B=b, steps=["act", "update_map",
                                                 "update_map", "act"],
                max_err_over_range=worst, launches=launches)


# --------------------------------------------------------------------------
# phase 5: the teacher-forcing training step at full width
# --------------------------------------------------------------------------
def frozen_snapshot(policy) -> dict:
    from ws_mgmap_tpu_torch.train.step import trainable

    return {k: p.detach().clone() for k, p in policy.named_parameters()
            if not trainable(k)}


def drive_train(ksplat, kconv) -> dict:
    """The update at N=5, T=64, fp32 (TF32 off), random weights from a
    seed: 6 updates on one fixed batch, the loss falling; then timed
    updates with remat off and on (host clock around synchronized rounds;
    peak memory of each mode); every kernel count read over all the
    updates (all 0: train mode keeps the fused conv off and the batch
    bypasses the mapping step) and the frozen trunks bit-identical; then
    a bf16 rollout engine built from the trained weights acts once with 1
    splat, 20 wgmma and 0 direct launches."""
    from ws_mgmap_tpu_torch.tools.synthetic import (TRAIN_LENGTHS,
                                                    random_policy,
                                                    train_episodes, wall_obs)
    from ws_mgmap_tpu_torch.train import step
    from ws_mgmap_tpu_torch.train.losses import MonitorConfig
    from ws_mgmap_tpu_torch.train.replay import collate_episodes
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    batch = collate_episodes(train_episodes(np.random.RandomState(11),
                                            TRAIN_LENGTHS))
    n, t = batch["weights"].shape
    if (n, t) != (5, 64):
        raise AssertionError(f"train batch [{n}, {t}], expected [5, 64]")
    state = step.create_train_state(random_policy(2, rotate_in_splat=True))
    frozen = frozen_snapshot(state.policy)
    update = step.make_train_step(MonitorConfig())
    reset_launches(ksplat, kconv)
    metrics = [update(state, batch) for _ in range(6)]
    losses = [float(m["loss"]) for m in metrics]
    last = {k: float(v) for k, v in metrics[-1].items()}
    if not (np.isfinite(losses).all() and all(np.isfinite(list(
            last.values())))):
        raise AssertionError(f"train: non-finite metrics {losses} {last}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")

    timed = {}
    for remat in (False, True):
        fn = step.make_train_step(MonitorConfig(), remat=remat)
        fn(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, ms_range = host_ms(lambda: fn(state, batch), 5, 2)
        timed["remat" if remat else "plain"] = dict(
            ms_per_update=ms, ms_per_update_range=ms_range,
            frames_per_s=n * t * 1e3 / ms,
            valid_frames_per_s=float(batch["weights"].sum()) * 1e3 / ms,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    launches = launch_counts(ksplat, kconv)
    if any(launches.values()):
        raise AssertionError(f"train: kernel launches {launches} over "
                             f"{state.step} updates, expected none")
    changed = [k for k, v in frozen_snapshot(state.policy).items()
               if not torch.equal(v, frozen[k])]
    if changed:
        raise AssertionError(f"train: frozen parameters moved: {changed[:4]}")

    b = PRODUCTION_B[0]
    eng = RolloutEngine(state.policy, b, compute_dtype=torch.bfloat16)
    obs = eng.batch_obs(wall_obs(b, 0.3, np.random.RandomState(12)))
    reset_launches(ksplat, kconv)
    out = eng.act(obs, np.zeros((b, 1)))
    act_launches = launch_counts(ksplat, kconv)
    want = {"splat_max": 1, "conv_wgmma": 20, "conv_direct": 0}
    if act_launches != want:
        raise AssertionError(f"act after training: launches {act_launches}, "
                             f"expected {want}")
    for name in ("action", "value", "prog", "hidden"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"act after training: non-finite {name}")
    return dict(phase="train", N=n, T=t, frames=n * t,
                valid_frames=int(batch["weights"].sum()), dtype="float32",
                updates=state.step, losses=losses, last_metrics=last,
                launches=launches, frozen_params=len(frozen),
                frozen_unchanged=True, **timed,
                act_after_training=dict(B=b, launches=act_launches))


# card vs CPU gradients: fp32 rounding through train-mode BN alone moves
# BN-coupled gradients by up to 7e-3 relative L2 when the episodes are
# permuted (the JAX package's measurement, tests/test_train_step.py), and
# by 1.2e-2 against float64 (tests/test_torch_train_step.py)
TRAIN_GRAD_RTOL = 1e-2


def parity_train() -> dict:
    """One update at N=2, T=4, full width, on the card and on the CPU from
    the same weights and batch: the loss within 1e-4 relative, and each
    trainable parameter's gradient within ``TRAIN_GRAD_RTOL`` relative L2
    of the CPU's, except where the CPU's gradient norm is below 1e-5 (a
    conv bias feeding train-mode BN has zero true gradient: both sides are
    rounding, and the card's must stay below 1e-4)."""
    from ws_mgmap_tpu_torch.tools.synthetic import (random_policy,
                                                    train_episodes)
    from ws_mgmap_tpu_torch.train import step
    from ws_mgmap_tpu_torch.train.losses import MonitorConfig
    from ws_mgmap_tpu_torch.train.replay import collate_episodes

    batch = collate_episodes(train_episodes(np.random.RandomState(13),
                                            (4, 3)), t_bucket=4)
    policy = random_policy(3, rotate_in_splat=False)
    update = step.make_train_step(MonitorConfig())
    grads, loss = {}, {}
    for dev in ("cuda", "cpu"):
        state = step.create_train_state(copy.deepcopy(policy), device=dev)
        loss[dev] = float(update(state, batch)["loss"])
        grads[dev] = {k: p.grad.detach().double().cpu()
                      for k, p in state.policy.named_parameters()
                      if p.grad is not None}
    if grads["cuda"].keys() != grads["cpu"].keys():
        raise AssertionError("train parity: different gradient sets")
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    if not loss_err <= 1e-4:
        raise AssertionError(f"train parity: loss {loss['cuda']} vs "
                             f"{loss['cpu']}")
    rel, degenerate = {}, 0
    for k, want in grads["cpu"].items():
        got, norm = grads["cuda"][k], float(want.norm())
        if norm < 1e-5:
            degenerate += 1
            if not float(got.norm()) < 1e-4:
                raise AssertionError(f"train parity: {k} degenerate on the "
                                     f"CPU, norm {float(got.norm())} here")
            continue
        rel[k] = float((got - want).norm()) / norm
    worst = dict(sorted(rel.items(), key=lambda kv: -kv[1])[:5])
    if not max(rel.values()) <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"train parity: gradient rel L2 {worst}")
    return dict(phase="train_parity", N=2, T=4, loss=loss["cuda"],
                loss_rel_err=loss_err, grad_rel_l2_worst=worst,
                grad_rel_l2_median=float(np.median(list(rel.values()))),
                tolerance=TRAIN_GRAD_RTOL, tensors=len(grads["cpu"]),
                degenerate=degenerate)


# --------------------------------------------------------------------------
# phase 6: data-parallel teacher forcing fed from the replay store
# --------------------------------------------------------------------------
DP_LOSS_RTOL = 1e-5  # loss and metrics, relative
DP_STAT_TOL = 1e-5   # BN running statistics, absolute and relative
DP_TIMEOUT_S = 600   # a launch of ranks that takes longer fails


def write_store(directory: Path, episodes) -> str:
    """``episodes`` into a store in ``directory`` with the port's writer;
    returns the writer's backend."""
    from ws_mgmap_tpu_torch.data.trajstore import TrajStoreWriter, pack_record

    w = TrajStoreWriter(str(directory))
    w.append_batch([pack_record(e) for e in episodes])
    w.close()
    return w.backend


def update_errors(got: dict, want: dict) -> dict:
    """One update's results against another's (``dist_train_check``'s
    ``snapshot``): the worst relative metric error, the worst BN
    statistics error (relative to 1 + |value|), each gradient's relative
    L2 error (a degenerate direction, reference norm below 1e-5, is listed
    where its norm here reaches 1e-4)."""
    if got["metrics"].keys() != want["metrics"].keys():
        raise AssertionError(f"metrics {sorted(got['metrics'])} vs "
                             f"{sorted(want['metrics'])}")
    if got["grads"].keys() != want["grads"].keys():
        raise AssertionError("different gradient sets")
    stats = [k for k in want["state"] if k.endswith(("running_mean",
                                                     "running_var"))]
    rel, degenerate, bad = {}, 0, []
    for k, g in want["grads"].items():
        norm = float(g.norm())
        if norm < 1e-5:
            degenerate += 1
            if not float(got["grads"][k].norm()) < 1e-4:
                bad.append(k)
            continue
        rel[k] = float((got["grads"][k].double() - g.double()).norm()) / norm
    return dict(
        metric_rel_err=max(abs(got["metrics"][k] - v) / abs(v)
                           for k, v in want["metrics"].items()),
        stat_err=max(float(((got["state"][k].double()
                             - want["state"][k].double()).abs()
                            / (1 + want["state"][k].double().abs())).max())
                     for k in stats),
        grad_rel_l2_max=max(rel.values()),
        grad_rel_l2_worst=dict(sorted(rel.items(),
                                      key=lambda kv: -kv[1])[:3]),
        grad_rel_l2_median=float(np.median(list(rel.values()))),
        degenerate=degenerate, degenerate_not_small=bad)


def check_update(errs: dict, what: str, loss_rtol: float = DP_LOSS_RTOL,
                 stat_tol: float = DP_STAT_TOL,
                 grad_rtol: float = TRAIN_GRAD_RTOL) -> None:
    """Raise unless ``errs`` (:func:`update_errors`) are within the
    tolerances."""
    if not (errs["metric_rel_err"] <= loss_rtol and errs["stat_err"]
            <= stat_tol and errs["grad_rel_l2_max"] <= grad_rtol
            and not errs["degenerate_not_small"]):
        raise AssertionError(f"{what}: {errs} beyond metrics {loss_rtol}, "
                             f"statistics {stat_tol}, gradients {grad_rtol}")


def compare_update(got: dict, want: dict, what: str) -> dict:
    """:func:`update_errors`, held to the fp32 tolerances."""
    errs = update_errors(got, want)
    check_update(errs, what)
    return errs


def ranks_identical(ranks: list, run: int, what: str) -> None:
    for r, res in enumerate(ranks[1:], 1):
        for k, v in ranks[0][run]["state"].items():
            if not torch.equal(res[run]["state"][k], v):
                raise AssertionError(f"{what}: rank {r}'s {k} differs from "
                                     "rank 0's")


def paired_overhead(plain: tuple, dp: tuple, batch: dict, rounds: int = 8,
                    per_round: int = 2) -> dict:
    """The distributed update's ms over the plain one's, timed in turns:
    each pair of rounds (``per_round`` synchronized updates each, host
    clock) runs the two in alternating order, and the overhead is the
    median of the pairs' differences, with their range."""
    def round_ms(state, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_round):
            fn(state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / per_round

    diffs = []
    for i in range(rounds):
        first, second = (plain, dp) if i % 2 == 0 else (dp, plain)
        ms = {id(first): round_ms(*first)}
        ms[id(second)] = round_ms(*second)
        diffs.append(ms[id(dp)] - ms[id(plain)])
    return dict(overhead_ms=float(np.median(diffs)),
                overhead_ms_range=[min(diffs), max(diffs)],
                overhead_pairs=rounds)


def one_rank_nccl(batch: dict, tmp: Path) -> dict:
    """A one-rank NCCL group in this process: the data-parallel update on
    the loader's batch against the plain update (phase 5's) from the same
    weights, in fp32 (the tolerances of ``compare_update``) and in float64
    (the CPU tests' exact ones); both fp32 updates also against the
    float64 plain one, to show each one's rounding. Then both fp32 updates
    timed (median of 5 rounds of 2 each, with the all-reduces of one
    update counted), and the overhead of the distributed one in 8 rounds
    taken in turns (:func:`paired_overhead`)."""
    import torch.distributed as dist

    from ws_mgmap_tpu_torch.models.layers import BatchNorm2d
    from ws_mgmap_tpu_torch.parallel import mesh
    from ws_mgmap_tpu_torch.tools import dist_train_check as dtc
    from ws_mgmap_tpu_torch.tools.synthetic import random_policy
    from ws_mgmap_tpu_torch.train import step
    from ws_mgmap_tpu_torch.train.losses import MonitorConfig

    for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        os.environ[k] = v
    mesh.init_distributed(init_method=f"file://{tmp / 'rendezvous'}",
                          timeout_s=DP_TIMEOUT_S)
    try:
        policy = random_policy(2, rotate_in_splat=False)
        plain_fn = step.make_train_step(MonitorConfig())
        dp_fn = step.make_train_step(MonitorConfig(), distributed=True)
        results = {}
        for dtype in (torch.float64, torch.float32):
            b = dtc.cast_batch(batch, dtype)
            plain = step.create_train_state(copy.deepcopy(policy).to(dtype))
            dp = step.create_train_state(copy.deepcopy(policy).to(dtype))
            mesh.replicate(dp.policy)
            results["plain", dtype] = dtc.snapshot(plain, plain_fn(plain, b))
            log: list = []
            with dtc.logged_all_reduces(log):
                results["dp", dtype] = dtc.snapshot(dp, dp_fn(dp, b))
        n_bn = sum(isinstance(m, BatchNorm2d) and m.training
                   for m in dp.policy.modules())
        times = {"plain": dtc.timed_updates(plain, plain_fn, batch, 5, 2),
                 "distributed": dtc.timed_updates(dp, dp_fn, batch, 5, 2)}
        overhead = paired_overhead((plain, plain_fn), (dp, dp_fn), batch)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    f32, f64 = torch.float32, torch.float64
    errs = {"fp32": update_errors(results["dp", f32], results["plain", f32]),
            "float64": update_errors(results["dp", f64],
                                     results["plain", f64]),
            "plain_fp32_vs_float64": update_errors(results["plain", f32],
                                                   results["plain", f64]),
            "dp_fp32_vs_float64": update_errors(results["dp", f32],
                                                results["plain", f64])}
    n, t = batch["weights"].shape
    row = dict(phase="data_parallel", group=f"{backend} x1 (this process)",
               N=n, T=t, dtype="float32", errors=errs,
               allreduces=len(log), train_bn_layers=n_bn,
               allreduces_formula="2 per train-mode BN + 3 loss + 1 bucket",
               bucket_bytes=log[-1][0],
               allreduce_bytes=sum(b for b, _ in log), **overhead,
               **times)
    try:
        check_update(errs["fp32"], "one-rank NCCL vs plain, fp32")
        check_update(errs["float64"], "one-rank NCCL vs plain, float64",
                     1e-9, 1e-9, 1e-7)
    except AssertionError:
        emit(dict(row, failed=True))
        raise
    return row


def dp_ranks(count: int, tmp: Path) -> list[dict]:
    """Ranks in subprocesses (``dist_train_check``), full width, fp32,
    random weights from a seed: each its shard of a store through its
    ``ReplayLoader`` (``fixed_len``), N=2, T=4 per rank, against the plain
    update of one process on the concatenated batch; the ranks'
    parameters bit-identical. Over NCCL with ``min(count, 4)`` ranks, one
    a card, then timed at the trainer's contract (N=5, T=200 per rank);
    with one card, two gloo ranks sharing it (untimed)."""
    from ws_mgmap_tpu_torch.tools import dist_train_check as dtc
    from ws_mgmap_tpu_torch.tools.synthetic import train_episodes

    world = min(count, 4) if count >= 2 else 2
    group = (f"nccl x{world} (one card each)" if count >= 2
             else "gloo x2 (sharing card 0)")
    rng = np.random.RandomState(14)
    write_store(tmp / "small", train_episodes(
        rng, rng.randint(2, 5, 2 * world)))
    runs = [dict(store="small", batch_size=2, max_len=4, dtype="float32",
                 remat=False)]
    if count >= 2:
        write_store(tmp / "big", train_episodes(
            rng, rng.randint(20, 60, 5 * world)))
        runs.append(dict(store="big", batch_size=5, max_len=200,
                         dtype="float32", remat=False, timed=[5, 2]))
    spec = dict(weights=None, seed=3, device="cuda",
                backend=None if count >= 2 else "gloo",
                timeout_s=DP_TIMEOUT_S, runs=runs)
    (tmp / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    dtc.launch_ranks(world, tmp, DP_TIMEOUT_S, shared_card=count < 2)
    launch_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    single = dtc.run_updates(dict(spec, runs=runs[:1]), tmp, None, world,
                             torch.device("cuda"))[0]
    errs = [compare_update(r[0], single, f"{group} rank {i} vs one process")
            for i, r in enumerate(ranks)]
    ranks_identical(ranks, 0, group)
    rows = [dict(phase="data_parallel", group=group, count=count,
                 N_per_rank=ranks[0][0]["N"], T=ranks[0][0]["T"],
                 dtype="float32", launch_s=launch_s,
                 worst=max(errs, key=lambda e: e["grad_rel_l2_max"]),
                 allreduces=ranks[0][0]["allreduces"],
                 bucket_bytes=ranks[0][0]["bucket_bytes"],
                 launches=[run["launches"] for r in ranks for run in r])]
    if count >= 2:
        ranks_identical(ranks, 1, group)
        timed = [r[1]["timed"] for r in ranks]
        rows.append(dict(phase="data_parallel_timed", group=group,
                         N_per_rank=ranks[0][1]["N"], T=ranks[0][1]["T"],
                         dtype="float32", per_rank=timed,
                         frames_per_s_total=sum(t["frames_per_s"]
                                                for t in timed),
                         all_reduce_share_max=max(t["all_reduce_share"]
                                                  for t in timed)))
    for r in ranks:
        for run in r:
            if any(run["launches"].values()):
                raise AssertionError(f"{group}: kernel launches "
                                     f"{run['launches']}")
    return rows


def drive_dp(ksplat, kconv) -> list[dict]:
    """Phase 6: the phase 5 cell's episodes into a store and back through
    ``ReplayLoader`` (exactly phase 5's collation, sorted by length), the
    one-rank NCCL group against the plain update, then ranks in
    subprocesses; 0 splat, wgmma and direct launches over every update."""
    import tempfile

    from ws_mgmap_tpu_torch.tools.synthetic import (TRAIN_LENGTHS,
                                                    train_episodes)
    from ws_mgmap_tpu_torch.train.replay import ReplayLoader, collate_episodes

    reset_launches(ksplat, kconv)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        episodes = train_episodes(np.random.RandomState(11), TRAIN_LENGTHS)
        backend = write_store(tmp / "store", episodes)
        loader = ReplayLoader(str(tmp / "store"), batch_size=5)
        batches = list(loader)
        want = collate_episodes(sorted(episodes, key=lambda e: len(
            e["prev_actions"])))
        if len(batches) != 1 or not _tree_equal(batches[0], want):
            raise AssertionError("store: the loader's batch is not the "
                                 "episodes' collation")
        rows = [dict(phase="store", backend=backend,
                     reader_backend=loader.reader.backend,
                     episodes=len(episodes),
                     store_bytes=sum(f.stat().st_size for f in
                                     (tmp / "store").iterdir()),
                     batch=list(batches[0]["weights"].shape))]
        (tmp / "one").mkdir()
        rows.append(one_rank_nccl(batches[0], tmp / "one"))
        (tmp / "ranks").mkdir()
        rows += dp_ranks(torch.cuda.device_count(), tmp / "ranks")
    launches = launch_counts(ksplat, kconv)
    if any(launches.values()):
        raise AssertionError(f"data parallel: kernel launches {launches}")
    rows[1]["count"] = torch.cuda.device_count()
    rows[1]["launches"] = launches
    return rows


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and np.array_equal(a, b)


# --------------------------------------------------------------------------
# phase 7: checkpoint evaluation on FakeSim
# --------------------------------------------------------------------------
# MAX_EPISODE_STEPS of the production run: the look-around and 16
# decisions (cut from 120 to leave the script's time to phase 8)
EVAL_CAP = 72
PARITY_CAP = 30   # the lockstep run: the look-around and two decisions
DDPPO_CAP = 40
EVAL_TOL = 1e-3   # of each output's range on the CPU, as in phase 4
METRIC_KEYS = ("distance_to_goal", "success", "spl", "ndtw", "path_length",
               "oracle_success", "oracle_navigation_error", "oracle_spl",
               "steps_taken", "sdtw")


def eval_config(processes: int, episodes: int, cap: int, *, bf16: bool,
                use_ddppo: bool = False, scenes: int | None = None):
    """The config a checkpoint's evaluation runs with, as the JAX trainer
    builds it (``trainer.py:474-519``): the port's ``CMA_AUG.yaml``,
    ``refine_config``, then the eval split, unshuffled, at most 11 envs.
    Cut to ``episodes`` FakeSim episodes on ``scenes`` scenes (by default
    one each; ``construct_envs`` deals whole scenes to the envs), of at
    most ``cap`` steps. bf16 is the production mode (``ROLLOUT_BF16`` +
    rotate-in-splat)."""
    from ws_mgmap_tpu_torch.config.default import get_config, refine_config

    cfg = refine_config(get_config("ws_mgmap_tpu_torch/config/CMA_AUG.yaml"))
    if not (Path(cfg.BASE_TASK_CONFIG_PATH).is_file()
            and cfg.TASK_CONFIG.DATASET.SPLIT == "train_aug"):
        raise AssertionError(f"the task config {cfg.BASE_TASK_CONFIG_PATH} "
                             "was not read")
    cfg = cfg.clone()
    cfg.defrost()
    cfg.TASK_CONFIG.DATASET.SPLIT = cfg.EVAL.SPLIT
    cfg.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
    cfg.NUM_PROCESSES = min(processes, 11)
    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = cap
    cfg.TASK_CONFIG.DATASET.FAKE_EPISODES = episodes
    cfg.TASK_CONFIG.DATASET.FAKE_SCENES = scenes or episodes
    cfg.EVAL.EPISODE_COUNT = episodes
    cfg.MODEL.ROLLOUT_BF16 = bf16
    cfg.MODEL.RGBMAPPING.rotate_in_splat = bf16
    cfg.use_ddppo = use_ddppo
    cfg.freeze()
    return cfg


def holds_card(pid: int) -> bool:
    """Whether process ``pid`` has a device file of the card open (a CUDA
    context opens /dev/nvidiactl and /dev/nvidia<N>; importing torch opens
    none)."""
    fd_dir = Path(f"/proc/{pid}/fd")
    for fd in fd_dir.iterdir():
        try:
            if os.readlink(fd).startswith("/dev/nvidia"):
                return True
        except FileNotFoundError:  # closed while we looked
            continue
    return False


class TimedEnvs:
    """The vector env ``evaluate`` builds, timing ``step`` and ``reset``
    on the host clock; on its first step it notes which workers hold the
    card (none may)."""

    def __init__(self, envs):
        self.envs = envs
        self.step_ms: list[float] = []
        self.reset_ms: list[float] = []
        self.env_steps = 0
        self.worker_pids = [p.pid for p in envs._procs]
        self.on_card: list[int] | None = None

    def __getattr__(self, name):
        return getattr(self.envs, name)

    def reset(self):
        t0 = time.perf_counter()
        out = self.envs.reset()
        self.reset_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def step(self, inputs):
        if self.on_card is None:
            self.on_card = [p for p in self.worker_pids if holds_card(p)]
        t0 = time.perf_counter()
        out = self.envs.step(inputs)
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self.env_steps += len(inputs)
        return out


class TimedEngine:
    """``evaluate``'s view of a ``RolloutEngine``, timing each call:
    ``batch_obs`` (stack and upload) on the host clock between
    synchronisations; ``act`` and ``update_map`` on the host clock and by
    CUDA events around them (their device span, read after the run)."""

    def __init__(self, engine):
        self.engine = engine
        self.host_ms: dict[str, list[float]] = {
            "batch_obs": [], "act": [], "update_map": []}
        self.events: dict[str, list] = {"act": [], "update_map": []}
        self.batch_sizes: list[int] = []

    @property
    def prog(self):
        return self.engine.prog

    def reset_state(self, num_envs: int) -> None:
        self.engine.reset_state(num_envs)

    def keep(self, keep) -> None:
        self.engine.keep(keep)

    def batch_obs(self, observations):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = self.engine.batch_obs(observations)
        torch.cuda.synchronize()
        self.host_ms["batch_obs"].append((time.perf_counter() - t0) * 1e3)
        return batch

    def _timed(self, kind: str, fn, batch, masks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn(batch, masks)
        end.record()
        self.host_ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.events[kind].append((start, end, len(masks)))
        self.batch_sizes.append(len(masks))
        return out

    def act(self, batch, masks):
        return self._timed("act", self.engine.act, batch, masks)

    def update_map(self, batch, masks):
        return self._timed("update_map", self.engine.update_map, batch, masks)

    def device_ms(self) -> dict[str, list[float]]:
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e, _ in v]
                for k, v in self.events.items()}

    def device_ms_by_batch(self) -> dict[str, dict[int, float]]:
        """The median device span of each kind of call at each batch."""
        out = {}
        for kind, ms in self.device_ms().items():
            batches = [b for *_, b in self.events[kind]]
            out[kind] = median_by(ms, batches)
        return out


def median_by(values: list[float], keys: list[int]) -> dict[int, float]:
    """The median of ``values`` for each key, keys in order."""
    return {k: float(np.median([v for v, kk in zip(values, keys) if kk == k]))
            for k in sorted(set(keys))}


def run_eval(cfg, engine, metric_dir: str, dataset=None, gt=None
             ) -> tuple[dict, TimedEnvs, float]:
    """``evaluate`` with env workers on ``dataset`` (by default the
    config's FakeSim split, made before the clock starts), its vector env
    timed; returns the aggregate, the timed envs and the wall seconds of
    the loop, the workers' start included."""
    from ws_mgmap_tpu_torch.env.vector_env import construct_envs
    from ws_mgmap_tpu_torch.train.evaluator import evaluate
    from ws_mgmap_tpu_torch.train.trainer import load_split

    split = cfg.EVAL.SPLIT
    if dataset is None:
        dataset, gt = load_split(cfg, split)
    t0 = time.perf_counter()
    envs = TimedEnvs(construct_envs(cfg, dataset, gt, auto_reset_done=False,
                                    workers=True))
    agg = evaluate(cfg, engine, dataset, gt,
                   episode_count=len(dataset.episodes),
                   log_fn=lambda s: print(s, flush=True),
                   metric_dir=metric_dir, split=split, envs=envs)
    return agg, envs, time.perf_counter() - t0


def check_eval(cfg, agg: dict, metric_dir: str, envs: TimedEnvs,
               n: int, what: str) -> dict:
    """Each of the split's ``n`` episodes ended once, the aggregate holds
    JAX's metric keys, each finite, both JSONs were written, and no
    worker held a CUDA context."""
    split = cfg.EVAL.SPLIT
    files = sorted(os.listdir(metric_dir))
    want_files = sorted([f"each_stat_ckpt_0_{split}.json",
                         f"stats_ckpt_0_{split}.json"])
    if files != want_files:
        raise AssertionError(f"{what}: metric files {files}")
    each = json.loads((Path(metric_dir) / want_files[0]).read_text())
    written = json.loads((Path(metric_dir) / want_files[1]).read_text())
    if len(each) != n:
        raise AssertionError(f"{what}: {len(each)} episodes ended, not {n}")
    if written != agg or not all(
            k in agg and math.isfinite(agg[k]) for k in METRIC_KEYS):
        raise AssertionError(f"{what}: aggregate {agg}")
    if max(m["steps_taken"] for m in each.values()) > \
            cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS:
        raise AssertionError(f"{what}: an episode outran the cap")
    # the check can see a context: this process holds one
    if envs.on_card is None or envs.on_card or not holds_card(os.getpid()):
        raise AssertionError(f"{what}: workers holding the card "
                             f"{envs.on_card}, this process "
                             f"{holds_card(os.getpid())}")
    return dict(episodes_ended=len(each), metrics=agg,
                steps_taken=sorted(m["steps_taken"] for m in each.values()),
                workers=len(envs.worker_pids), workers_holding_card=0)


def uneven_split(cfg, n: int = EVAL_PROCESSES):
    """The production split: ``n`` FakeSim scenes, one to each env
    worker, the i-th (in scene order) cut to its first i + 1 episodes. An
    env pauses when its episodes are done, so the batch falls from n to 1
    as the run goes on (rounds of n, n - 1, ..., 1 envs where every
    episode runs to the cap)."""
    from ws_mgmap_tpu_torch.env.dataset import VLNCEDataset
    from ws_mgmap_tpu_torch.train.trainer import load_split

    dataset, gt = load_split(cfg, cfg.EVAL.SPLIT)
    scenes = dataset.scenes()
    if len(scenes) != n:
        raise AssertionError(f"{len(scenes)} scenes for {n} envs")
    episodes = []
    for i, scene in enumerate(scenes):
        own = [e for e in dataset.episodes if e.scene_id == scene]
        if len(own) < i + 1:
            raise AssertionError(f"scene {scene}: {len(own)} episodes")
        episodes += own[:i + 1]
    return VLNCEDataset(episodes, dataset.vocab), gt


def eval_production(ksplat, kconv) -> dict:
    """The production eval: bf16 + rotate-in-splat, 5 env workers over
    ``uneven_split``'s 15 episodes. Times the loop and splits a loop step
    into the env step (workers), batch_obs (stack and upload), act and
    update_map; counts every launch (act: 1 splat, 20 wgmma; update_map:
    1, 16); checks that envs paused on the card (the batch fell)."""
    import tempfile

    from ws_mgmap_tpu_torch.env.vector_env import worker_threads
    from ws_mgmap_tpu_torch.models.policy import MGMapConfig
    from ws_mgmap_tpu_torch.tools.synthetic import random_policy
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    cfg = eval_config(EVAL_PROCESSES, EVAL_PROCESSES ** 2, EVAL_CAP,
                      bf16=True, scenes=EVAL_PROCESSES)
    dataset, gt = uneven_split(cfg)
    n = len(dataset.episodes)
    policy = random_policy(0, rotate_in_splat=True)
    if MGMapConfig.from_config(cfg.MODEL) != policy.cfg:
        raise AssertionError("the eval config describes another model")
    torch.cuda.reset_peak_memory_stats()
    engine = TimedEngine(RolloutEngine(policy, cfg.NUM_PROCESSES,
                                       compute_dtype=torch.bfloat16))
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(ksplat, kconv)
        agg, envs, wall = run_eval(cfg, engine, tmp, dataset, gt)
        launches = launch_counts(ksplat, kconv)
        row = check_eval(cfg, agg, tmp, envs, n, "production eval")
    dev = engine.device_ms()
    acts, maps = len(dev["act"]), len(dev["update_map"])
    loop_steps = len(envs.step_ms)
    want = {"splat_max": acts + maps, "conv_wgmma": 20 * acts + 16 * maps,
            "conv_direct": 0}
    if launches != want or loop_steps != acts + maps:
        raise AssertionError(f"production eval: launches {launches}, "
                             f"expected {want} over {loop_steps} steps")
    if min(engine.batch_sizes) >= EVAL_PROCESSES:
        raise AssertionError("production eval: no env paused, batch sizes "
                             f"{sorted(set(engine.batch_sizes))}")
    per_step = {
        "env_step": sum(envs.step_ms) / loop_steps,
        "env_reset": sum(envs.reset_ms) / loop_steps,
        "batch_obs": sum(engine.host_ms["batch_obs"]) / loop_steps,
        "act_device": sum(dev["act"]) / loop_steps,
        "update_map_device": sum(dev["update_map"]) / loop_steps,
        "act_host": sum(engine.host_ms["act"]) / loop_steps,
        "update_map_host": sum(engine.host_ms["update_map"]) / loop_steps}
    loop_ms = wall * 1e3 / loop_steps
    return dict(phase="eval", mode="bf16+rotate_in_splat", dtype="bfloat16",
                processes=cfg.NUM_PROCESSES, episodes=n,
                episodes_per_env=list(range(1, EVAL_PROCESSES + 1)),
                max_episode_steps=EVAL_CAP, split=cfg.EVAL.SPLIT,
                worker_threads=worker_threads(cfg.NUM_PROCESSES), **row,
                wall_s=wall, episodes_per_s=n / wall,
                env_steps=envs.env_steps,
                env_steps_per_s=envs.env_steps / wall,
                loop_steps=loop_steps, acts=acts, update_maps=maps,
                ms_per_loop_step=loop_ms, ms_per_loop_step_split=per_step,
                share_of_loop_step={
                    "env_step": per_step["env_step"] / loop_ms,
                    "batch_obs": per_step["batch_obs"] / loop_ms,
                    "engine_host": (per_step["act_host"]
                                    + per_step["update_map_host"]) / loop_ms},
                act_device_ms=float(np.median(dev["act"])),
                update_map_device_ms=float(np.median(dev["update_map"])),
                # by batch: the env step (the slowest live worker's) and
                # the engine's spans as envs pause
                env_step_ms_by_batch=median_by(envs.step_ms,
                                               engine.batch_sizes),
                device_ms_by_batch=engine.device_ms_by_batch(),
                batch_sizes=sorted(set(engine.batch_sizes)),
                loop_steps_by_batch={b: engine.batch_sizes.count(b)
                                     for b in sorted(set(engine.batch_sizes))},
                launches=launches,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


class Lockstep:
    """Two engines fed the same batches and masks: the card's drives the
    envs; the CPU's outputs hold it, each within ``EVAL_TOL`` of the CPU
    value's range: every decision's waypoint and prog, every step's ego
    map and global map."""

    def __init__(self, gpu, cpu):
        self.gpu, self.cpu = gpu, cpu
        self.worst: dict[str, float] = {}
        self.steps = 0
        self.decisions = 0
        self.batch_sizes: set[int] = set()

    @property
    def prog(self):
        return self.gpu.prog

    def reset_state(self, num_envs: int) -> None:
        self.gpu.reset_state(num_envs)
        self.cpu.reset_state(num_envs)

    def keep(self, keep) -> None:
        self.gpu.keep(keep)
        self.cpu.keep(keep)

    def batch_obs(self, observations):
        return self.gpu.batch_obs(observations), self.cpu.batch_obs(
            observations)

    def _hold(self, name: str, got: torch.Tensor, want: torch.Tensor):
        scale = float(want.abs().max())
        err = float((got.float().cpu() - want.float()).abs().max())
        self.worst[name] = max(self.worst.get(name, 0.0), err / max(scale,
                                                                   1e-30))
        if not err <= EVAL_TOL * scale:
            raise AssertionError(f"lockstep step {self.steps} {name}: {err} "
                                 f"vs range {scale}")

    def act(self, batch, masks):
        og = self.gpu.act(batch[0], masks)
        oc = self.cpu.act(batch[1], masks)
        self._hold("waypoint", og.action, oc.action)
        self._hold("prog", og.prog, oc.prog)
        self._hold("ego_map", og.ego_map, oc.ego_map)
        self._hold("global_map", self.gpu.global_map, self.cpu.global_map)
        self.steps += 1
        self.decisions += 1
        self.batch_sizes.add(len(masks))
        return og

    def update_map(self, batch, masks):
        eg = self.gpu.update_map(batch[0], masks)
        ec = self.cpu.update_map(batch[1], masks)
        self._hold("ego_map", eg, ec)
        self._hold("global_map", self.gpu.global_map, self.cpu.global_map)
        self.steps += 1
        self.batch_sizes.add(len(masks))
        return eg


def eval_lockstep(ksplat, kconv) -> dict:
    """fp32 (TF32 off) at B=2, one short episode per env: the card
    engine and a CPU engine with the same weights in lockstep; the splat
    on every step, no wgmma conv (fp32 keeps the library conv)."""
    import tempfile

    from ws_mgmap_tpu_torch.tools.synthetic import random_policy
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    cfg = eval_config(2, 2, PARITY_CAP, bf16=False)
    policy = random_policy(1, rotate_in_splat=False)
    lock = Lockstep(RolloutEngine(policy, 2),
                    RolloutEngine(policy, 2, device="cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(ksplat, kconv)
        agg, envs, wall = run_eval(cfg, lock, tmp)
        launches = launch_counts(ksplat, kconv)
        row = check_eval(cfg, agg, tmp, envs, 2, "lockstep eval")
    if (launches["splat_max"] != lock.steps or launches["conv_wgmma"]
            or launches["conv_direct"] or lock.decisions == 0):
        raise AssertionError(f"lockstep eval: launches {launches} over "
                             f"{lock.steps} steps, {lock.decisions} "
                             "decisions")
    return dict(phase="eval_fp32_lockstep", dtype="float32", B=2, episodes=2,
                batch_sizes=sorted(lock.batch_sizes),
                max_episode_steps=PARITY_CAP, steps_compared=lock.steps,
                decisions_compared=lock.decisions, tolerance=EVAL_TOL,
                max_err_over_range=lock.worst, launches=launches,
                wall_s=wall, **row)


def eval_ddppo(ksplat, kconv) -> dict:
    """``use_ddppo``: 2 env workers, 2 episodes, each worker's DD-PPO
    controller on the CPU (random init: no checkpoint in the checkout)
    turning the waypoints into actions."""
    import tempfile

    from ws_mgmap_tpu_torch.env.vector_env import worker_threads
    from ws_mgmap_tpu_torch.tools.synthetic import random_policy
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    cfg = eval_config(2, 2, DDPPO_CAP, bf16=True, use_ddppo=True)
    engine = TimedEngine(RolloutEngine(random_policy(0, rotate_in_splat=True),
                                       2, compute_dtype=torch.bfloat16))
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(ksplat, kconv)
        agg, envs, wall = run_eval(cfg, engine, tmp)
        launches = launch_counts(ksplat, kconv)
        row = check_eval(cfg, agg, tmp, envs, 2, "DD-PPO eval")
    steps = len(envs.step_ms)
    if launches["splat_max"] != steps:
        raise AssertionError(f"DD-PPO eval: launches {launches} over "
                             f"{steps} steps")
    return dict(phase="eval_ddppo", dtype="bfloat16", processes=2, episodes=2,
                batch_sizes=sorted(set(engine.batch_sizes)),
                max_episode_steps=DDPPO_CAP,
                worker_threads=worker_threads(2), wall_s=wall,
                loop_steps=steps,
                env_step_ms=float(np.median(envs.step_ms)),
                env_step_ms_range=[min(envs.step_ms), max(envs.step_ms)],
                launches=launches, **row)


def ddppo_parity() -> dict:
    """``PointNavResNetPolicy.act`` at full size on the card against the
    CPU, B=4, masks 0 and 1, the same seeded weights: logits, value and
    hidden state within ``EVAL_TOL`` of their range, the same argmax. A
    row whose argmax differs is listed with its top-two gap on the CPU;
    it fails unless that gap is inside the logits' tolerance (a tie)."""
    from ws_mgmap_tpu_torch.models.ddppo_policy import DdppoController

    b = 4
    rng = np.random.RandomState(13)
    inputs = (torch.from_numpy(rng.rand(b, 256, 256, 1).astype(np.float32)),
              torch.from_numpy(np.stack([rng.rand(b) * 5, rng.randn(b)], 1)
                               .astype(np.float32)),
              torch.from_numpy(rng.randint(0, 4, b)),
              torch.from_numpy(rng.randn(4, b, 512).astype(np.float32)),
              torch.tensor([[0.0], [1.0], [0.0], [1.0]]))
    outs = {}
    for dev in ("cuda", "cpu"):
        ctrl = DdppoController(seed=5, device=dev)
        with torch.no_grad():
            outs[dev] = ctrl.policy.act(*(x.to(dev) for x in inputs))
        if dev == "cuda":
            gpu_ctrl = ctrl
    worst, flips = {}, []
    for i, name in ((1, "logits"), (2, "value"), (3, "hidden")):
        want, got = outs["cpu"][i], outs["cuda"][i].cpu()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        worst[name] = err / scale
        if not err <= EVAL_TOL * scale:
            raise AssertionError(f"DD-PPO act {name}: {err} vs range {scale}")
    logits = outs["cpu"][1]
    tol = EVAL_TOL * float(logits.abs().max())
    for row in range(b):
        a_gpu, a_cpu = int(outs["cuda"][0][row]), int(outs["cpu"][0][row])
        if a_gpu != a_cpu:
            top2 = logits[row].topk(2).values
            gap = float(top2[0] - top2[1])
            flips.append(dict(row=row, card=a_gpu, cpu=a_cpu, cpu_gap=gap))
            if gap > tol:
                raise AssertionError(f"DD-PPO act row {row}: argmax {a_gpu} "
                                     f"on the card, {a_cpu} on the CPU, gap "
                                     f"{gap} > {tol}")
    with torch.no_grad():
        card = [x.cuda() for x in inputs]
        ms, host = cuda_ms(lambda: gpu_ctrl.policy.act(*card), 10)
    return dict(phase="ddppo_act_parity", B=b, masks=[0, 1, 0, 1],
                tolerance=EVAL_TOL, max_err_over_range=worst,
                argmax=[int(a) for a in outs["cuda"][0]],
                argmax_flips=flips, card_act_ms=ms, card_act_host_ms=host)


def env_host_step(steps: int = 30) -> dict:
    """One FakeSim env of the production run's config in this process (no
    worker, no card): ms per reset and per step, driven by the oracle
    waypoint, then by random waypoints after a look-around; every
    default sensor on."""
    from ws_mgmap_tpu_torch.env.environments import VLNCEDaggerEnv
    from ws_mgmap_tpu_torch.train.trainer import load_split

    cfg = eval_config(1, 2, EVAL_CAP, bf16=True)
    dataset, gt = load_split(cfg, cfg.EVAL.SPLIT)
    env = VLNCEDaggerEnv(cfg, dataset, gt, auto_reset_done=False)
    env.reset()  # builds the scene; the timed resets reuse it
    t0 = time.perf_counter()
    obs = env.reset()
    reset_ms = (time.perf_counter() - t0) * 1e3
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        obs, _, done, _ = env.step(
            {"action": np.arctanh(np.clip(obs["waypoint"], -0.99, 0.99)),
             "prog": -1})
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if done:
            obs = env.reset()
    # after the look-around, random waypoints (as an untrained policy's):
    # the follower plans to a new cell on most steps
    rng = np.random.RandomState(0)
    random_ms = []
    obs = env.reset()
    for t in range(24 + steps):
        action = (rng.randn(2) if t >= 24
                  else np.arctanh(np.clip(obs["waypoint"], -0.99, 0.99)))
        t0 = time.perf_counter()
        obs, _, done, _ = env.step({"action": action, "prog": -1})
        if t >= 24:
            random_ms.append((time.perf_counter() - t0) * 1e3)
        if done:
            obs = env.reset()
    return dict(phase="env_host_step", rgb=list(obs["rgb"].shape),
                depth=list(obs["depth"].shape), sensors=sorted(obs),
                reset_ms=reset_ms, step_ms=float(np.median(step_ms)),
                step_ms_range=[min(step_ms), max(step_ms)], steps=steps,
                random_waypoint_step_ms=float(np.median(random_ms)),
                random_waypoint_step_ms_range=[min(random_ms),
                                               max(random_ms)],
                cpu_count=os.cpu_count(),
                torch_threads=torch.get_num_threads())


def drive_eval(ksplat, kconv) -> list[dict]:
    """Phase 7, from the repo root (the config's task YAML path is
    relative to it)."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        return [env_host_step(), eval_production(ksplat, kconv),
                eval_lockstep(ksplat, kconv), eval_ddppo(ksplat, kconv),
                ddppo_parity()]
    finally:
        os.chdir(cwd)


# --------------------------------------------------------------------------
# phase 8: train -> eval -> inference through the CLI on FakeSim
# --------------------------------------------------------------------------
CLI_CONFIG = "ws_mgmap_tpu_torch/config/FAKESIM_DEBUG.yaml"
# bf16 rollouts; cut to depth: splits of 4 FakeSim episodes, not the
# YAML's 6 (beta 1 collects each once; eval while training runs 2 rounds
# of the 2 envs, not 3), episodes of at most 36 steps, not 80 (the
# look-around and 4 decisions; ep_max_len stays 80)
CLI_OPTS = ["MODEL.ROLLOUT_BF16", "True",
            "TASK_CONFIG.DATASET.FAKE_EPISODES", "4",
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "36"]
# each checkpoint's evaluation: one round of the 2 envs, not the YAML's 3
# episodes (two rounds)
CLI_EVAL_EPISODES = 2
# inference on a split of 3 episodes: 2 on one env, so it pauses
CLI_INFERENCE_EPISODES = 3


class EngineCalls:
    """Every ``RolloutEngine.act`` and ``update_map`` call of the process
    while installed (the engines are the trainer's own): kind, batch and
    dtype, in order."""

    def __init__(self):
        self.calls: list[tuple[str, int, str]] = []

    def __enter__(self):
        from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

        self._real = (RolloutEngine.act, RolloutEngine.update_map)
        real_act, real_map = self._real
        calls = self.calls

        def act(engine, batch, masks):
            calls.append(("act", len(masks), str(engine.dtype).split(".")[-1]))
            return real_act(engine, batch, masks)

        def update_map(engine, batch, masks):
            calls.append(("update_map", len(masks),
                          str(engine.dtype).split(".")[-1]))
            return real_map(engine, batch, masks)

        RolloutEngine.act, RolloutEngine.update_map = act, update_map
        return self

    def __exit__(self, *exc):
        from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

        RolloutEngine.act, RolloutEngine.update_map = self._real

    def since(self, start: int) -> dict:
        """The calls from index ``start`` on: counts, env steps (the sum of
        the batches), batches and dtypes."""
        calls = self.calls[start:]
        return dict(acts=sum(k == "act" for k, _, _ in calls),
                    update_maps=sum(k == "update_map" for k, _, _ in calls),
                    env_steps=sum(b for _, b, _ in calls),
                    batch_sizes=sorted({b for _, b, _ in calls}),
                    dtypes=sorted({d for _, _, d in calls}))


class TrainerProbe:
    """Installed around the CLI's runs: each collection with its own
    ``StepTimers`` (wall, episodes, engine calls), each training update
    (host ms between synchronisations, batch shape, kernel launches) and
    every trainer log line."""

    def __init__(self, ksplat, kconv, engine: EngineCalls):
        self.ksplat, self.kconv, self.engine = ksplat, kconv, engine
        self.collections: list[dict] = []
        self.updates: list[dict] = []
        self.logs: list[str] = []

    def __enter__(self):
        from ws_mgmap_tpu_torch.train import step
        from ws_mgmap_tpu_torch.train import trainer
        from ws_mgmap_tpu_torch.utils.profiling import StepTimers

        self._real = (trainer.collect_dataset, step.make_train_step,
                      trainer.DaggerTrainer._log)
        real_collect, real_make, real_log = self._real
        probe = self

        def collect(config, engine, dataset, gt, store, data_it, *a, **k):
            timers = StepTimers()
            start = len(probe.engine.calls)
            t0 = time.perf_counter()
            n = real_collect(config, engine, dataset, gt, store, data_it,
                             *a, timers=timers, **k)
            wall = time.perf_counter() - t0
            calls = probe.engine.since(start)
            summary = timers.summary()
            probe.collections.append(dict(
                data_it=data_it, beta=config.DAGGER.P ** data_it,
                episodes=n, wall_s=wall, episodes_per_s=n / wall,
                env_steps_per_s=calls["env_steps"] / wall, **calls,
                timers={k: dict(count=v["count"], total_s=v["total_s"],
                                mean_ms=v["mean_ms"])
                        for k, v in summary.items()},
                share_of_wall={k: v["total_s"] / wall
                               for k, v in summary.items()}))
            return n

        def make_train_step(*a, **k):
            update = real_make(*a, **k)

            def timed(state, batch):
                torch.cuda.synchronize()
                before = launch_counts(probe.ksplat, probe.kconv)
                t0 = time.perf_counter()
                metrics = update(state, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                after = launch_counts(probe.ksplat, probe.kconv)
                probe.updates.append(dict(
                    ms=ms, N=int(batch["weights"].shape[0]),
                    T=int(batch["weights"].shape[1]),
                    launches=sum(after.values()) - sum(before.values())))
                return metrics
            return timed

        def log(trainer_self, msg):
            probe.logs.append(msg)
            real_log(trainer_self, msg)

        trainer.collect_dataset = collect
        step.make_train_step = make_train_step
        trainer.DaggerTrainer._log = log
        return self

    def __exit__(self, *exc):
        from ws_mgmap_tpu_torch.train import step
        from ws_mgmap_tpu_torch.train import trainer

        (trainer.collect_dataset, step.make_train_step,
         trainer.DaggerTrainer._log) = self._real


def cli_run(argv: list[str], ksplat, kconv, engine: EngineCalls
            ) -> tuple[dict, float, dict]:
    """``python -m ws_mgmap_tpu_torch.run`` in this process, its launches
    counted from 0; returns (launches, wall s, engine calls)."""
    from ws_mgmap_tpu_torch.run import main as cli_main

    start = len(engine.calls)
    reset_launches(ksplat, kconv)
    t0 = time.perf_counter()
    cli_main(argv)
    wall = time.perf_counter() - t0
    return launch_counts(ksplat, kconv), wall, engine.since(start)


def check_cli_launches(what: str, launches: dict, calls: dict) -> None:
    """1 splat per engine step, 16 wgmma per update_map and 20 per act (bf16
    rollouts), no direct conv, nothing else on the card."""
    want = {"splat_max": calls["acts"] + calls["update_maps"],
            "conv_wgmma": 20 * calls["acts"] + 16 * calls["update_maps"],
            "conv_direct": 0}
    if launches != want or calls["dtypes"] != ["bfloat16"]:
        raise AssertionError(f"{what}: launches {launches}, expected {want} "
                             f"over {calls}")


def check_metric_file(path: Path, what: str) -> dict:
    stats = json.loads(path.read_text())
    if not all(k in stats and math.isfinite(stats[k]) for k in METRIC_KEYS):
        raise AssertionError(f"{what}: metrics {stats}")
    return stats


def drive_cli(ksplat, kconv) -> list[dict]:
    """Phase 8: ``FAKESIM_DEBUG.yaml`` at full width with bf16 rollouts
    through the port's CLI, in this process so that launches are counted:
    ``--run-type train`` (2 envs in forkserver workers; 2 DAgger
    iterations, beta 1 then 0.75, each collecting 4 episodes of at most
    36 steps and training 2 epochs in batches of 2; eval-while-training
    after each), ``eval`` of the checkpoint folder (4 checkpoints, 2
    val_seen episodes each) and ``inference`` of the last checkpoint on a
    test split of 3 episodes; the splits cut to 4 FakeSim episodes. Held: the store's records read back, 4
    checkpoints loading strictly into a fresh policy, no eval-while-
    training failure logged, every evaluation's 10 metric keys finite
    and both JSONs written, each inference episode recorded once, exact
    launches in each run and none in the updates."""
    import shutil
    import tempfile

    from ws_mgmap_tpu_torch.config.default import get_config
    from ws_mgmap_tpu_torch.data.trajstore import TrajStoreReader
    from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
    from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib
    from ws_mgmap_tpu_torch.train.replay import ReplayLoader
    from ws_mgmap_tpu_torch.train.trainer import load_split

    model_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    base = ["-c", CLI_CONFIG, "-e", str(model_dir)]
    rows = []
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = get_config(CLI_CONFIG, CLI_OPTS)
        with EngineCalls() as engine, TrainerProbe(ksplat, kconv,
                                                   engine) as probe:
            torch.cuda.reset_peak_memory_stats()
            launches, wall, calls = cli_run(
                ["--run-type", "train"] + base + CLI_OPTS, ksplat, kconv,
                engine)
            check_cli_launches("cli train", launches, calls)
            failed = [m for m in probe.logs if "eval-while-training failed" in m]
            if failed:
                raise AssertionError(f"cli train: {failed}")
            if any(u["launches"] for u in probe.updates):
                raise AssertionError(f"cli train: launches in the updates "
                                     f"{probe.updates}")
            run_dir = model_dir / "run_train_base"
            store = run_dir / "trajectories.lmdb"
            reader = TrajStoreReader(str(store))
            stored = len(reader)
            reader.close()
            want = cfg.DAGGER.ITERATIONS * cfg.DAGGER.UPDATE_SIZE
            read_back = sum(int(b["weights"].shape[0]) for b in ReplayLoader(
                str(store), cfg.DAGGER.BATCH_SIZE, max_len=cfg.ep_max_len))
            if stored < want or read_back != stored - stored % 2:
                raise AssertionError(f"cli train: {stored} records (want >= "
                                     f"{want}), {read_back} read back")
            ckpt_dir = run_dir / "checkpoint"
            n_ckpt = cfg.DAGGER.ITERATIONS * cfg.DAGGER.EPOCHS
            names = sorted(os.listdir(ckpt_dir))
            if names != sorted(f"ckpt.{i}.pth" for i in range(n_ckpt)):
                raise AssertionError(f"cli train: checkpoints {names}")
            for name in names:
                blob = ckpt_lib.load_checkpoint(str(ckpt_dir / name))
                BasePolicy(MGMapConfig.from_config(cfg.MODEL)).load_state_dict(
                    blob["state_dict"], strict=True)
            evals = [m for m in probe.logs if m.startswith("[eval]")]
            if len(evals) != cfg.DAGGER.ITERATIONS:
                raise AssertionError(f"cli train: eval-while-training logs "
                                     f"{evals}")
            ums = [u["ms"] for u in probe.updates]
            rows.append(dict(
                phase="cli_train", config=CLI_CONFIG, opts=CLI_OPTS,
                dtype="bfloat16", processes=cfg.NUM_PROCESSES,
                iterations=cfg.DAGGER.ITERATIONS, epochs=cfg.DAGGER.EPOCHS,
                wall_s=wall, store_records=stored, records_read_back=read_back,
                checkpoints=names, checkpoints_load_strict=True,
                eval_while_training=evals, eval_while_training_failures=0,
                collections=probe.collections, updates=len(ums),
                update_shapes=sorted({(u["N"], u["T"])
                                      for u in probe.updates}),
                ms_per_update=float(np.median(ums)),
                ms_per_update_range=[min(ums), max(ums)],
                update_launches=0, launches=launches, **calls,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))

            launches, wall, calls = cli_run(
                ["--run-type", "eval"] + base + CLI_OPTS + [
                    "EVAL_CKPT_PATH_DIR", str(ckpt_dir),
                    "EVAL.POLL_IDLE_TIMEOUT", "1.0",
                    "EVAL.EPISODE_COUNT", str(CLI_EVAL_EPISODES)],
                ksplat, kconv, engine)
            check_cli_launches("cli eval", launches, calls)
            metric_dir = model_dir / "run_eval_base" / "metric"
            split = cfg.EVAL.SPLIT
            stats, ended = {}, {}
            for i in range(n_ckpt):
                stats[i] = check_metric_file(
                    metric_dir / f"stats_ckpt_{i}_{split}.json", "cli eval")
                each = json.loads((metric_dir / f"each_stat_ckpt_{i}_{split}"
                                   ".json").read_text())
                # the loop ends once as many distinct episodes ended
                ended[i] = len(each)
                if not CLI_EVAL_EPISODES <= len(each) <= 4:
                    raise AssertionError(f"cli eval ckpt {i}: {len(each)} "
                                         "episodes")
            rows.append(dict(phase="cli_eval", dtype="bfloat16",
                             checkpoints=n_ckpt,
                             episode_count=CLI_EVAL_EPISODES,
                             episodes_ended=ended, split=split,
                             wall_s=wall, env_steps_per_s=calls[
                                 "env_steps"] / wall,
                             metrics=stats, launches=launches, **calls))

            pred = model_dir / "predictions.json"
            inf_opts = ["INFERENCE.CKPT_PATH", str(ckpt_dir / names[-1]),
                        "INFERENCE.PREDICTIONS_FILE", str(pred),
                        "TASK_CONFIG.DATASET.FAKE_EPISODES",
                        str(CLI_INFERENCE_EPISODES), "EVAL.EPISODE_COUNT",
                        str(CLI_INFERENCE_EPISODES)]
            launches, wall, calls = cli_run(
                ["--run-type", "inference"] + base + CLI_OPTS + inf_opts,
                ksplat, kconv, engine)
            check_cli_launches("cli inference", launches, calls)
            predictions = json.loads(pred.read_text())
            inf_cfg = get_config(CLI_CONFIG, CLI_OPTS + inf_opts)
            split_ids = sorted(str(e.episode_id) for e in load_split(
                inf_cfg, inf_cfg.INFERENCE.SPLIT)[0].episodes)
            if sorted(predictions) != split_ids or not all(
                    len(t) >= 24 for t in predictions.values()):
                raise AssertionError(f"cli inference: {sorted(predictions)} "
                                     f"for the split's {split_ids}")
            rows.append(dict(phase="cli_inference", dtype="bfloat16",
                             split=inf_cfg.INFERENCE.SPLIT,
                             episodes=len(predictions), wall_s=wall,
                             env_steps_per_s=calls["env_steps"] / wall,
                             steps_per_episode=sorted(
                                 len(t) for t in predictions.values()),
                             launches=launches, **calls))
    finally:
        os.chdir(cwd)
        shutil.rmtree(model_dir, ignore_errors=True)
    return rows


# --------------------------------------------------------------------------
# phase 9: eval videos, one engine over several cards, no habitat fallback
# --------------------------------------------------------------------------
VIDEO_PROCESSES = 3   # env workers holding 1, 2 and 3 episodes
VIDEO_CAP = 36        # the look-around and 4 decisions
VIDEO_NUM = 4         # of the split's 6 episodes
LOOK_AROUND = 24      # steps before the first decision (no maps yet)
TILE = 240
SPLIT_B = (6, 24)     # the engine split's batches (24 only with 2+ cards)
# the split vs one engine, of each output's scale on the one engine (the
# larger of its range and its largest magnitude: prog's 6 values lie close
# together): the kernels are per image (exact), cuDNN's bf16 convolutions
# may take other algorithms at the chunks' batch
SPLIT_TOL = 2 ** -5


def decode_png(data: bytes) -> np.ndarray:
    """The [H, W, 3] uint8 frame of a PNG as ``env/viz.py::encode_png``
    writes it (8-bit RGB, no interlace, every row unfiltered); each
    chunk's CRC checked."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise AssertionError(f"PNG chunk {kind}: bad CRC")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = ihdr
    if (depth, colour, interlace) != (8, 2, 0):
        raise AssertionError(f"PNG header {ihdr}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError("PNG rows with a filter")
    return rows[:, 1:].reshape(h, w, 3)


class VideoProbe:
    """``env/viz.py``'s compositor and writer as ``evaluate`` calls them,
    timed on the host clock: each frame's composition
    (``observations_to_image`` and ``append_text_to_image``) and each
    video's writing; every video's frames are kept (episode id ->
    (directory, frames))."""

    NAMES = ("observations_to_image", "append_text_to_image",
             "generate_video")

    def __init__(self, viz):
        self.viz = viz
        self.real = {n: getattr(viz, n) for n in self.NAMES}
        self.compose_ms: list[float] = []
        self.write_ms: list[float] = []
        self.videos: dict[str, tuple[str, list]] = {}

    def __enter__(self):
        real, started = self.real, []

        def compose(*a, **k):
            started.append(time.perf_counter())
            return real["observations_to_image"](*a, **k)

        def text(img, text):
            out = real["append_text_to_image"](img, text)
            self.compose_ms.append((time.perf_counter() - started.pop())
                                   * 1e3)
            return out

        def write(video_dir, frames, episode_id, **kw):
            t0 = time.perf_counter()
            path = real["generate_video"](video_dir, frames, episode_id, **kw)
            self.write_ms.append((time.perf_counter() - t0) * 1e3)
            self.videos[episode_id] = (path, list(frames))
            return path

        for name, fn in zip(self.NAMES, (compose, text, write)):
            setattr(self.viz, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.viz, name, fn)


def frame_width(t: int) -> int:
    """The width of JAX's frame at step t of an episode with the GT
    semantic map sensor on: rgb, first-person semantics, the GT map and
    the legend until the first decision; then the predicted map in the
    GT map's place, and the attention."""
    return (3 if t < LOOK_AROUND else 4) * TILE + 120


def check_videos(probe: VideoProbe, video_dir: Path, each: dict) -> dict:
    """VIDEO_NUM directories, one an ended episode, a frame a step of the
    JAX compositor's shape; every PNG decodes to the frame written; the
    semantic panel changes, and so do the map and attention panels after
    the first decision."""
    dirs = sorted(p.name for p in video_dir.iterdir())
    if len(dirs) != VIDEO_NUM or len(probe.videos) != VIDEO_NUM:
        raise AssertionError(f"videos: {dirs}, {len(probe.videos)} written")
    png_bytes, frames_total = 0, 0
    for ep, (path, frames) in probe.videos.items():
        steps = each[ep]["steps_taken"]
        name = f"episode={ep}-ckpt=0-spl={each[ep]['spl']:.2f}"
        pngs = sorted(Path(path).iterdir())
        if Path(path).name != name or len(frames) != steps or len(
                pngs) != steps:
            raise AssertionError(f"video {path}: {len(frames)} frames, "
                                 f"{len(pngs)} PNGs, {steps} steps")
        changed = {"semantic": False, "map": False, "attention": False}
        for t, (frame, png) in enumerate(zip(frames, pngs)):
            if frame.shape != (TILE + 40, frame_width(t), 3):
                raise AssertionError(f"{name} frame {t}: {frame.shape}")
            data = png.read_bytes()
            png_bytes += len(data)
            if not np.array_equal(decode_png(data), frame):
                raise AssertionError(f"{png}: decodes to another frame")
            panels = {"semantic": frame[:TILE, TILE:2 * TILE]}
            if t >= LOOK_AROUND:
                panels.update(map=frame[:TILE, 2 * TILE:3 * TILE],
                              attention=frame[:TILE, 3 * TILE:4 * TILE])
            for k, v in panels.items():
                changed[k] |= len(np.unique(v.reshape(-1, 3), axis=0)) > 1
        if not all(changed.values()):
            raise AssertionError(f"{name}: constant panels {changed}")
        frames_total += len(frames)
    return dict(videos=len(dirs), frames=frames_total,
                png_bytes_per_frame=png_bytes / frames_total)


def png_levels(viz, frames: list) -> dict:
    """ms and bytes per frame of the PNG writer's zlib at level 1 and 6,
    on ``frames``."""
    out = {}
    for level in (1, 6):
        t0 = time.perf_counter()
        sizes = [len(viz.encode_png(f, level)) for f in frames]
        out[level] = dict(ms_per_frame=(time.perf_counter() - t0) * 1e3
                          / len(frames),
                          bytes_per_frame=sum(sizes) / len(frames))
    out["bytes_ratio_1_to_6"] = (out[1]["bytes_per_frame"]
                                 / out[6]["bytes_per_frame"])
    return out


def eval_videos(policy, ksplat, kconv) -> list[dict]:
    """The production eval cut to 3 env workers holding 1, 2 and 3 of 6
    FakeSim episodes of at most 36 steps, bf16 + rotate-in-splat, with
    ``VIDEO_OPTION ["disk"]``, ``VIDEO_NUM`` 4 and the sensors a video
    eval adds (the trainer's ``add_video_sensors``); then the same split
    without videos, paired: the videos' cost on the wall and per frame."""
    import tempfile

    from ws_mgmap_tpu_torch.env import viz
    from ws_mgmap_tpu_torch.models.policy import MGMapConfig
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine
    from ws_mgmap_tpu_torch.train.trainer import add_video_sensors

    cfg = eval_config(VIDEO_PROCESSES, VIDEO_PROCESSES ** 2, VIDEO_CAP,
                      bf16=True, scenes=VIDEO_PROCESSES)
    dataset, gt = uneven_split(cfg, VIDEO_PROCESSES)
    n = len(dataset.episodes)
    if MGMapConfig.from_config(cfg.MODEL) != policy.cfg:
        raise AssertionError("the eval config describes another model")
    engine = RolloutEngine(policy, cfg.NUM_PROCESSES,
                           compute_dtype=torch.bfloat16)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        video_dir = Path(tmp) / "videos"
        vcfg = cfg.clone()
        vcfg.defrost()
        vcfg.VIDEO_OPTION = ["disk"]
        vcfg.VIDEO_DIR = str(video_dir)
        vcfg.VIDEO_NUM = VIDEO_NUM
        add_video_sensors(vcfg)
        vcfg.freeze()
        for name, run_cfg in (("video", vcfg), ("no_video", cfg)):
            timed = TimedEngine(engine)
            metric_dir = Path(tmp) / name
            with VideoProbe(viz) as probe:
                reset_launches(ksplat, kconv)
                agg, envs, wall = run_eval(run_cfg, timed, str(metric_dir),
                                           dataset, gt)
                launches = launch_counts(ksplat, kconv)
            row = check_eval(run_cfg, agg, str(metric_dir), envs, n,
                             f"{name} eval")
            dev = timed.device_ms()
            acts, maps = len(dev["act"]), len(dev["update_map"])
            loop_steps = len(envs.step_ms)
            want = {"splat_max": acts + maps,
                    "conv_wgmma": 20 * acts + 16 * maps, "conv_direct": 0}
            if launches != want or loop_steps != acts + maps:
                raise AssertionError(f"{name} eval: launches {launches}, "
                                     f"expected {want}")
            each = json.loads((metric_dir / "each_stat_ckpt_0_"
                               f"{cfg.EVAL.SPLIT}.json").read_text())
            row = dict(phase="eval_video" if name == "video"
                       else "eval_no_video", dtype="bfloat16",
                       processes=cfg.NUM_PROCESSES, episodes=n,
                       max_episode_steps=VIDEO_CAP, **row, wall_s=wall,
                       loop_steps=loop_steps,
                       ms_per_loop_step=wall * 1e3 / loop_steps,
                       ms_per_loop_step_split={
                           "env_step": sum(envs.step_ms) / loop_steps,
                           "env_reset": sum(envs.reset_ms) / loop_steps,
                           "batch_obs": sum(timed.host_ms["batch_obs"])
                           / loop_steps,
                           "engine_host": (sum(timed.host_ms["act"])
                                           + sum(timed.host_ms["update_map"]))
                           / loop_steps,
                           "compose": sum(probe.compose_ms) / loop_steps,
                           "write": sum(probe.write_ms) / loop_steps},
                       env_steps_per_s=envs.env_steps / wall,
                       batch_sizes=sorted(set(timed.batch_sizes)),
                       launches=launches)
            if name == "video":
                row.update(check_videos(probe, video_dir, each))
                compose = sum(probe.compose_ms)
                write = sum(probe.write_ms)
                row.update(
                    video_option=["disk"], video_num=VIDEO_NUM,
                    compose_ms_per_frame=float(np.median(probe.compose_ms)),
                    composed_frames=len(probe.compose_ms),
                    write_ms_per_frame=write / row["frames"],
                    video_share_of_loop_step=(compose + write)
                    / (wall * 1e3),
                    png_levels=png_levels(
                        viz, next(iter(probe.videos.values()))[1]))
            elif probe.compose_ms or probe.videos:
                raise AssertionError("the eval without videos composed "
                                     "frames")
            rows.append(row)
    rows[0]["wall_over_no_video"] = rows[0]["wall_s"] / rows[1]["wall_s"]
    rows[0]["metrics_equal_no_video"] = (rows[0]["metrics"]
                                         == rows[1]["metrics"])
    return rows


def split_drive(policy, ksplat, kconv) -> list[dict]:
    """One bf16 engine against the same engine split over every card (on
    a one-card machine two replicas on ``cuda:0``: the semantics, not a
    speed-up) on the wall spin at B=6: 2 map-update steps and an act,
    then ``keep`` to 5 envs (one chunk) and a map-update step, to 4 (the
    chunks of 4) and an act. The ego map, global map, waypoint and hidden
    state are held within ``SPLIT_TOL`` of their scale after each step;
    each step launches its kernels once per chunk. Then both are timed
    (B=6, and B=24 where there are 2 or more cards)."""
    from ws_mgmap_tpu_torch.tools.synthetic import (instruction_tokens,
                                                    wall_obs)
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    cards = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(cards)] if cards >= 2
               else ["cuda:0", "cuda:0"])
    per_step = {"act": {"splat_max": 1, "conv_wgmma": 20, "conv_direct": 0},
                "update_map": {"splat_max": 1, "conv_wgmma": 16,
                               "conv_direct": 0}}
    b = SPLIT_B[0]
    one = RolloutEngine(policy, b, compute_dtype=torch.bfloat16)
    split = RolloutEngine(policy, b, compute_dtype=torch.bfloat16,
                          devices=devices)
    gen = np.random.RandomState(9)
    tok = instruction_tokens(b, gen)
    errs: dict[str, float] = {}
    chunk_sizes, total = set(), {k: 0 for k in per_step["act"]}

    def rel(name, got, want):
        got, want = got.float().to(want.device), want.float()
        span = max(float(want.max() - want.min()),
                   float(want.abs().max())) or 1.0
        err = float((got - want).abs().max()) / span
        errs[name] = max(errs.get(name, 0.0), err)

    def step(kind, k, rows):
        obs = one.batch_obs(wall_obs(len(rows), math.radians(15 * k), gen,
                                     tokens=tok[rows]))
        masks = np.zeros((len(rows), 1)) if k == 0 else np.ones(
            (len(rows), 1))
        reset_launches(ksplat, kconv)
        got = getattr(split, kind)(obs, masks)
        ran = launch_counts(ksplat, kconv)
        want = getattr(one, kind)(obs, masks)
        chunks = len(split.chunks)
        expect = {key: v * chunks for key, v in per_step[kind].items()}
        if ran != expect:
            raise AssertionError(f"split {kind} at B={len(rows)} over "
                                 f"{chunks} chunks: launches {ran}, "
                                 f"expected {expect}")
        for key in total:
            total[key] += ran[key]
        chunk_sizes.update(b - a for a, b in split.chunks)
        if kind == "act":
            for f in ("action", "hidden", "ego_map", "prog"):
                rel(f, getattr(got, f), getattr(want, f))
        else:
            rel("ego_map", got, want)
        rel("global_map", split.global_map, one.global_map)
        rel("hidden", split.hidden, one.hidden)

    rows = list(range(b))
    for k, kind in enumerate(("update_map", "update_map", "act")):
        step(kind, k, rows)
    chunks_by_b = {b: len(split.chunks)}
    for keep, kind in (([0, 1, 2, 3, 5], "update_map"), ([0, 1, 2, 4],
                                                        "act")):
        rows = [rows[i] for i in keep]
        one.keep(keep)
        split.keep(keep)
        rel("global_map", split.global_map, one.global_map)
        rel("hidden", split.hidden, one.hidden)
        step(kind, 3 + len(chunks_by_b), rows)
        chunks_by_b[len(rows)] = len(split.chunks)
    bad = {k: v for k, v in errs.items() if not v <= SPLIT_TOL}
    if bad:
        raise AssertionError(f"split vs one engine: {bad} of the scale "
                             f"(all: {errs})")

    # timed: update_map and act, one engine vs the split, paired
    timed = {}
    for tb in SPLIT_B if cards >= 2 else SPLIT_B[:1]:
        engines = {"one": RolloutEngine(policy, tb,
                                        compute_dtype=torch.bfloat16),
                   "split": RolloutEngine(policy, tb,
                                          compute_dtype=torch.bfloat16,
                                          devices=devices)}
        obs = engines["one"].batch_obs(wall_obs(tb, 0.0, gen,
                                                tokens=instruction_tokens(
                                                    tb, gen)))
        ones = np.ones((tb, 1))
        res = {}
        for name in ("one", "split", "split", "one"):
            eng = engines[name]
            for kind in ("update_map", "act"):
                getattr(eng, kind)(obs, ones)
                ms, rng = host_ms(lambda: getattr(eng, kind)(obs, ones), 3,
                                  4)
                res.setdefault(f"{name}_{kind}_ms", []).append(ms)
        timed[tb] = dict(chunks=len(engines["split"].chunks), **res)
    return [dict(phase="engine_split", dtype="bfloat16", cards=cards,
                 devices=devices, B=b, chunks_by_batch=chunks_by_b,
                 batch_sizes=sorted(chunk_sizes), launches=total,
                 max_rel_err=errs, tol=SPLIT_TOL, timed_ms=timed)]


def habitat_gate() -> dict:
    """A non-FakeSim simulator without habitat-sim: ``construct_envs``
    raises ``ImportError`` before any env worker starts, and nothing
    falls back to FakeSim."""
    from ws_mgmap_tpu_torch.env import habitat_backend
    from ws_mgmap_tpu_torch.env.vector_env import construct_envs
    from ws_mgmap_tpu_torch.train.trainer import load_split

    cfg = eval_config(1, 1, VIDEO_CAP, bf16=True)
    dataset, gt = load_split(cfg, cfg.EVAL.SPLIT)
    cfg.defrost()
    cfg.TASK_CONFIG.SIMULATOR.TYPE = "Sim-v0"
    cfg.freeze()
    if habitat_backend.HABITAT_AVAILABLE:
        raise AssertionError("habitat_sim is installed: the gate cannot "
                             "be checked")
    try:
        envs = construct_envs(cfg, dataset, gt, auto_reset_done=False,
                              workers=True)
    except ImportError as e:
        if "habitat_sim" not in str(e):
            raise AssertionError(f"ImportError without habitat_sim: {e}")
        return dict(phase="habitat_gate", simulator="Sim-v0",
                    raised="ImportError", message=str(e))
    envs.close()
    raise AssertionError("Sim-v0 without habitat_sim built envs")


def drive_phase9(policy, ksplat, kconv) -> list[dict]:
    """Phase 9, from the repo root (the config's task YAML path is
    relative to it)."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        return (eval_videos(policy, ksplat, kconv)
                + split_drive(policy, ksplat, kconv) + [habitat_gate()])
    finally:
        os.chdir(cwd)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep-tiles", action="store_true",
                    help="also time the wgmma conv with every tile at every "
                         "call site (phase 2b')")
    ap.add_argument("--splat-ablation", action="store_true",
                    help="also time the splat with parts of it taken out "
                         "(phase 2a')")
    args = ap.parse_args()
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
    policy = random_policy(0, rotate_in_splat=True)
    splat_rows = check_splat(ksplat, gen, policy)
    emit(dict(phase="kernels", kernel="splat_max", cases=splat_rows))
    if args.splat_ablation:
        for row in splat_ablation(ksplat, build, gen, policy):
            emit(row)
    conv_rows = check_conv(kconv, gen)
    emit(dict(phase="kernels", kernel="conv3x3_bn_relu", cases=conv_rows))
    conv_t = {}
    for b in CONV_B:
        for step in STEP_KINDS:
            conv_t[b, step] = conv_per_step(conv_rows, b, step)
            emit(conv_t[b, step])
    if args.sweep_tiles:
        for row in sweep_tiles(kconv, gen):
            emit(row)

    # phase 3: the map-update step at full width, production mode
    slice_rows = [drive_production(policy, b, ksplat, kconv)
                  for b in PRODUCTION_B]
    for r in slice_rows:
        emit(r)
    # phase 3b: the decision path (act + update_map) at full width
    act_rows = [drive_act(policy, b, ksplat, kconv) for b in PRODUCTION_B]
    for r in act_rows:
        emit(r)

    # phase 4: fp32 parity mode, card vs CPU
    emit(parity_fp32(random_policy(1, rotate_in_splat=False), ksplat, kconv))

    # phase 5: the training step at full width, and its card-vs-CPU parity
    train_row = drive_train(ksplat, kconv)
    emit(train_row)
    emit(parity_train())

    # phase 6: data-parallel teacher forcing from the replay store
    for row in drive_dp(ksplat, kconv):
        emit(row)

    # phase 7: checkpoint evaluation on FakeSim (env workers, evaluate)
    eval_rows = drive_eval(ksplat, kconv)
    for row in eval_rows:
        emit(row)

    # phase 8: train -> eval -> inference through the CLI on FakeSim
    cli_rows = drive_cli(ksplat, kconv)
    for row in cli_rows:
        emit(row)

    # phase 9: eval videos, the engine split, the habitat gate
    video_rows = drive_phase9(policy, ksplat, kconv)
    for row in video_rows:
        emit(row)

    # each batch and dtype phases 7-9 ran the kernels at was held in
    # phase 2
    splat_held = {(r["B"], r["dtype"]) for r in splat_rows}
    wgmma_held = {r["B"] for r in conv_rows if r["variant"] == "wgmma"}
    for row in eval_rows + cli_rows + video_rows:
        for b in row.get("batch_sizes", ()):
            if (b, row["dtype"]) not in splat_held or (
                    row["dtype"] == "bfloat16" and b not in wgmma_held):
                raise AssertionError(f"{row['phase']}: the kernels ran at "
                                     f"B={b} {row['dtype']}, which phase 2 "
                                     "did not check")

    # the kernels line: launches from the main-path runs of phases 3, 3b,
    # 5, 7, 8 and 9 (the training step launches none; phase 7's and 9's
    # evaluations, phase 8's runs and phase 9's split steps, each counted
    # from 0); times for one B=6 bf16
    # map-update step (splat once, the 16 fused convs by call site; the
    # act step's 20 are in its conv_per_step line); the direct conv is off
    # the main path and timed at the fp32 site
    sp = splat_rows[1]
    conv6 = conv_t[6, "update_map"]
    direct = next(r for r in conv_rows if r["dtype"] == "float32")

    def launched(key):
        return sum(r["launches"][key]
                   for r in (slice_rows + act_rows + [train_row]
                             + eval_rows + cli_rows + video_rows)
                   if "launches" in r)

    def bound_by(ops_ms, bytes_ms):
        return "operations" if ops_ms >= bytes_ms else "bytes"

    emit({"kernels": [
        {"name": "splat_max", "route": "cuda",
         "source": "ws_mgmap_tpu_torch/ops/kernels/csrc/splat.cu",
         "replaces": "ws_mgmap_tpu/ops/pallas/splat.py:195",
         "launches": launched("splat_max"),
         "max_abs_err": max(r["max_abs_err"] for r in splat_rows),
         "ms": sp["ms"], "plain_ms": sp["plain_ms"],
         "bound_ms": sp["bound_ms"], "bound_by": sp["bound_by"],
         "library_ms": sp["library_ms"]},
        {"name": "conv3x3_bn_relu_wgmma", "route": "cuda",
         "source": "ws_mgmap_tpu_torch/ops/kernels/csrc/conv3x3_wgmma.cu",
         "replaces": "ws_mgmap_tpu/ops/pallas/conv.py:113",
         "launches": launched("conv_wgmma"),
         "max_abs_err": max(r["max_abs_err"] for r in conv_rows
                            if r["variant"] == "wgmma"),
         "ms": conv6["ms"], "plain_ms": conv6["plain_ms"],
         "bound_ms": conv6["bound_ms"],
         "bound_by": bound_by(conv6["ops_ms"], conv6["bytes_ms"]),
         "library_ms": conv6["library_ms"]},
        {"name": "conv3x3_bn_relu_direct", "route": "cuda",
         "source": "ws_mgmap_tpu_torch/ops/kernels/csrc/conv3x3.cu",
         "replaces": "ws_mgmap_tpu/ops/pallas/conv.py:113",
         "launches": launched("conv_direct"),
         "max_abs_err": max(r["max_abs_err"] for r in conv_rows
                            if r["variant"] == "direct"),
         "ms": direct["ms"], "plain_ms": direct["plain_ms"],
         "bound_ms": direct["bound_ms"], "bound_by": direct["bound_by"],
         "library_ms": direct["library_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
