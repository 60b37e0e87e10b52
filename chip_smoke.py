#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py [--sweep-tiles] [--splat-ablation]

Builds the port's CUDA kernels from ``ws_mgmap_tpu_torch/ops/kernels/csrc``
(into ``build/ws_mgmap_tpu_torch/``), holds each kernel against its plain
PyTorch twin at the main path's shapes and times both (the splat on
synthetic ids, on the ids of a B=6 and a B=24 step
of the wall spin, and untimed on edge values: NaN, infinities, signed
zeros; the fused conv's wgmma kernel at every UNet call site at B=6 and
B=24 and its direct kernel at an fp32 and a ragged-channel shape; with
``--sweep-tiles`` also the wgmma kernel with every tile; with
``--splat-ablation`` also variants of the splat with a part taken out),
then drives the
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

import argparse
import ctypes
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
    """Four synthetic cases, the B=6 and B=24 steps of the wall spin, and
    edge values (NaN, infinities, signed zeros, maxima <= -1e16)."""
    from ws_mgmap_tpu_torch.tools.synthetic import special_splat_inputs

    rows = []
    for b, dtype in ((6, torch.float32), (6, torch.bfloat16),
                     (24, torch.bfloat16), (13, torch.bfloat16)):
        feats, ids = splat_inputs(b, dtype, gen)
        rows.append(splat_case(ksplat, "synthetic", feats, ids))
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
PRODUCTION_B = (6, 24)  # the production drives' batches


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


def conv_case(kconv, name, h, c1, c2, co, res, dtype, b, gen):
    """One call site: the kernel that the dispatch picks vs the twin (and
    which kernel it was), then the times of that kernel (weights in its
    own layout, as the UNet passes them), the twin, cuDNN, and at bf16 the
    direct kernel too."""
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
            tile_th_bn=list(kconv.wgmma_tile(b, h, h, c1 + c2, co)),
            grid=list(kconv.wgmma_grid(b, h, h, c1 + c2, co)))
    esz = x.element_size()
    flops = 2.0 * b * h * h * 9 * (c1 + c2) * co
    nbytes = esz * (x.numel() + (0 if x2 is None else x2.numel()) + w.numel()
                    + got.numel() + (0 if residual is None else
                                     residual.numel())) + 8 * co
    bound = bound_ms(nbytes, flops, dtype)
    return dict(site=name, H=h, C1=c1, C2=c2, Co=co, residual=res, B=b,
                dtype=str(dtype).split(".")[-1], variant=variant,
                max_abs_err=float(diff.max()), tol_rtol_atol=[rtol, atol],
                ms=kern, host_ms=host, plain_ms=plain, library_ms=lib,
                gflop=flops / 1e9,
                tflops=flops / kern / 1e9,
                share_of_bound=bound["bound_ms"] / kern, **extra, **bound)


def check_conv(kconv, gen) -> list[dict]:
    """The wgmma kernel at every call site at both production batches (its
    tile, and so its template instance and grid, depends on the batch),
    the direct kernel at an fp32 and a ragged-channel shape."""
    rows = [conv_case(kconv, *site[:6], torch.bfloat16, b, gen)
            for b in PRODUCTION_B for site in CONV_SITES]
    rows.append(conv_case(kconv, "layer1 conv+res fp32", 56, 64, 0, 64,
                          True, torch.float32, 6, gen))
    rows.append(conv_case(kconv, "ragged 96+32->70 bf16", 28, 96, 32, 70,
                          False, torch.bfloat16, 6, gen))
    return rows


def conv_per_step(rows: list[dict], b: int) -> dict:
    """The 16 fused calls of one bf16 step at batch b, summed by call
    site."""
    per_step = {s[0]: s[6] for s in CONV_SITES}
    sites = [r for r in rows if r["B"] == b and r["dtype"] == "bfloat16"
             and r["site"] in per_step]
    t = {k: sum(r[k] * per_step[r["site"]] for r in sites)
         for k in ("ms", "host_ms", "direct_ms", "plain_ms", "library_ms",
                   "bound_ms", "bytes_ms", "ops_ms")}
    return dict(phase="conv_per_step", B=b, dtype="bfloat16", **t,
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
        for name, h, c1, c2, co, res, _ in CONV_SITES:
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
    kconv.conv3x3_bn_relu_wgmma.launches = 0
    kconv.conv3x3_bn_relu_direct.launches = 0
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
    round_ms = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(per_round):
            eng.update_map(obs[k % spin], np.ones((b, 1)))
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3 / per_round)
    ms = float(np.median(round_ms))
    launches = {"splat_max": ksplat.splat_max.launches,
                **conv_launches(kconv)}
    steps = spin + warm + rounds * per_round

    # checks: launches, shapes, the wall, the ring, the reset
    if launches["splat_max"] != steps:
        raise AssertionError(f"B={b}: splat launched {launches} times, "
                             f"expected {steps}")
    if launches["conv_wgmma"] != 16 * steps or launches["conv_direct"]:
        raise AssertionError(f"B={b}: conv launches {launches}, expected "
                             f"{16 * steps} wgmma and 0 direct")
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
                ms_per_step=ms, ms_per_step_range=[min(round_ms),
                                                   max(round_ms)],
                frames_per_s=b * 1e3 / ms,
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
    kconv.conv3x3_bn_relu_wgmma.launches = 0
    kconv.conv3x3_bn_relu_direct.launches = 0
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
    launches = {"splat_max": ksplat.splat_max.launches,
                **conv_launches(kconv)}
    if launches["conv_wgmma"] or launches["conv_direct"]:
        raise AssertionError(f"fp32 parity mode must keep the library conv: "
                             f"{launches}")
    return dict(phase="fp32_parity", B=b, steps=steps,
                max_err_over_range=worst, launches=launches)


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
    for b in PRODUCTION_B:
        conv_t[b] = conv_per_step(conv_rows, b)
        emit(conv_t[b])
    if args.sweep_tiles:
        for row in sweep_tiles(kconv, gen):
            emit(row)

    # phase 3: the slice at full width, production mode
    slice_rows = [drive_production(policy, b, ksplat, kconv)
                  for b in PRODUCTION_B]
    for r in slice_rows:
        emit(r)

    # phase 4: fp32 parity mode, card vs CPU
    emit(parity_fp32(random_policy(1, rotate_in_splat=False), ksplat, kconv))

    # the kernels line: launches from the main-path runs of phase 3; times
    # for one B=6 bf16 step (splat once, the 16 fused convs by call site);
    # the direct conv is off the main path and timed at the fp32 site
    sp = splat_rows[1]
    conv6 = conv_t[6]
    direct = next(r for r in conv_rows if r["dtype"] == "float32")

    def launched(key):
        return sum(r["launches"][key] for r in slice_rows)

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
