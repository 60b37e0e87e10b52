"""Fused 3x3 conv + folded BN (+ residual) (+ ReLU): wrappers, twin and gate.

Port of ``ws_mgmap_tpu/ops/pallas/conv.py``: :func:`fold_bn`,
:func:`conv3x3_bn_relu` (plain twin :func:`conv3x3_bn_relu_plain`) and the
gate that decides where the UNet uses it (:func:`fused_conv_eligible`,
:func:`set_fused_conv_mode`, :func:`fused_conv_active`). All tensors are
NHWC; the public function and the twin take an HWIO ``[3, 3, Ci, Co]``
weight, and each kernel's wrapper the layout of :func:`kernel_weight`.

On the card two hand-written kernels compute it, chosen by shape
(:func:`conv_variant`), each with its own launch count:

- :func:`conv3x3_bn_relu_wgmma` (``csrc/conv3x3_wgmma.cu``): an implicit
  GEMM on the bf16 tensor cores, fed by TMA, for bf16 with C1 and C2
  multiples of 64 and Co a multiple of 8 (every UNet site at width 1);
- :func:`conv3x3_bn_relu_direct` (``csrc/conv3x3.cu``): an implicit GEMM
  in fp32 FMA on the CUDA cores, fed by a cp.async ring, for fp32 (which
  the tensor cores would round to TF32) and ragged channel counts; tile
  from :func:`direct_tile`.

A wrapper runs the twin only for a CPU tensor; for a CUDA tensor it
launches its kernel or raises.

Under fused mode "auto" (the default) every eligible site of a bf16 or
fp32 tensor on the card takes its kernel: bf16 the wgmma one, fp32 the
direct one. Here the gate parts from the JAX package's, which fuses bf16
alone: there the alternative for fp32 was XLA's convolution, here it is
cuDNN, whose heuristics pick FFT convolutions for the UNet's fp32 sites
at a rollout's batch (about 11x the direct kernel's device time a step at
B=6). On the CPU "auto" fuses nothing.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ws_mgmap_tpu_torch.ops.kernels import build

NUM_SMS = 132  # H100 SXM
TILE_W = 8  # the wgmma kernel's tile width in pixels
# (TH, BN) tiles of the wgmma kernel; on equal L2 traffic the first wins
WGMMA_TILES = ((16, 128), (8, 128), (16, 64), (8, 64))
MIN_BLOCKS = 2 * NUM_SMS // 3  # a tile must keep two thirds of the SMs busy
# The direct kernel's tiles, as compiled in csrc/conv3x3.cu
# (WS_DIRECT_TILES): (TH, TW, BN, KC, split, stages) is TH x TW pixels x
# BN channels, the input walked in chunks of KC channels through a ring of
# `stages`, each chunk's work shared by `split` thread groups. Each maps
# to (blocks one SM holds, by the card's occupancy calculator and held
# against it by a card test; device speed where every tile fills the card
# -- the 224^2 sites -- relative to the fastest), both measured on an H100
# (chip_smoke.py --sweep-tiles).
DIRECT_TILES = {
    (8, 16, 64, 16, 1, 2): (2, 1.0),
    (8, 16, 64, 16, 3, 2): (1, 0.97),
    (8, 8, 64, 16, 2, 2): (2, 0.87),
    (8, 8, 64, 8, 2, 3): (3, 0.87),
}
# direct_cost's latency terms (fitted to the same sweep): a lone warp
# issues FMAs at this share of its SM sub-partition's rate, and each chunk
# adds this many cycles of barrier and copy wait to a block's critical path
DIRECT_ONE_WARP_RATE = 0.7
DIRECT_CHUNK_CYCLES = 1000


def fold_bn(conv_bias: torch.Tensor | None, gamma: torch.Tensor,
            beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Frozen BN(conv(x) + b0) == conv(x) * scale + bias, per output
    channel, in fp32 (whatever the dtype of the stored statistics)."""
    gamma = gamma.to(torch.float32)
    scale = gamma * torch.rsqrt(var.to(torch.float32) + eps)
    b0 = 0.0 if conv_bias is None else conv_bias.to(torch.float32)
    bias = beta.to(torch.float32) + (b0 - mean.to(torch.float32)) * scale
    return scale, bias


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, Ci, Co]`` -> ``[9*Co, Ci]``, K-major: row
    ``(dx*3 + dy)*Co + co`` holds ``w[dy, dx, :, co]``, so the weight
    tiles of the three dy taps of one dx lie in one TMA box."""
    ci, co = w.shape[2], w.shape[3]
    return w.permute(1, 0, 3, 2).reshape(9 * co, ci).contiguous()


def unpack_weight(w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_weight`."""
    return w.reshape(3, 3, -1, w.shape[1]).permute(1, 0, 3, 2).contiguous()


def conv3x3_bn_relu_plain(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          relu: bool = True,
                          residual: torch.Tensor | None = None,
                          x2: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: ``F.conv2d`` over the
    channel concat in fp32, ``* scale + bias``, ``+ residual``, ReLU, then
    the input dtype. ``w`` is HWIO."""
    if x2 is not None:
        x = torch.cat([x, x2], dim=-1)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float32),
                 w.permute(3, 2, 0, 1).to(torch.float32), padding=1)
    y = y.permute(0, 2, 3, 1) * scale.to(torch.float32) + bias.to(
        torch.float32)
    if residual is not None:
        y = y + residual.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def conv_variant(dtype: torch.dtype, c1: int, c2: int, co: int) -> str:
    """The dispatch rule for a CUDA tensor. "wgmma" for bf16 with C1 and
    C2 (0 when there is no x2) multiples of 64 and Co a multiple of 8: a
    64-channel K step then never straddles x and x2, and every TMA stride
    is a multiple of 16 bytes. "direct" for everything else: fp32 and
    ragged channel counts."""
    if (dtype == torch.bfloat16 and c1 > 0 and c1 % 64 == 0
            and c2 % 64 == 0 and co % 8 == 0):
        return "wgmma"
    return "direct"


def kernel_weight(w_hwio: torch.Tensor, variant: str) -> torch.Tensor:
    """An HWIO weight in the layout that ``variant``'s kernel takes:
    packed (:func:`pack_weight`) for "wgmma", HWIO for "direct"."""
    return pack_weight(w_hwio) if variant == "wgmma" else w_hwio.contiguous()


def _blocks(b: int, h: int, w: int, co: int, tile) -> int:
    th, bn = tile
    return b * math.ceil(h / th) * math.ceil(w / TILE_W) * math.ceil(co / bn)


def _l2_bytes(b: int, h: int, w: int, ci: int, co: int, tile) -> int:
    """Bytes the blocks pull through L2 (bf16): every Co tile reads the
    input once per dx, each band of TH rows with its two halo rows (what
    lies outside the image is zero-filled, not read); every pixel tile
    reads the weight slice of its Co tile."""
    th, bn = tile
    pixel_tiles = b * math.ceil(h / th) * math.ceil(w / TILE_W)
    co_tiles = math.ceil(co / bn)
    rows = h + 2 * math.ceil(h / th)
    return 2 * ci * co_tiles * (3 * b * rows * w + 9 * pixel_tiles * bn)


def wgmma_tile(b: int, h: int, w: int, ci: int, co: int
               ) -> tuple[int, int]:
    """(TH, BN) for the wgmma kernel: TH x 8 pixels x BN channels. The
    kernel is bound by what it pulls through L2 (:func:`_l2_bytes`), so the
    tile is the one of :data:`WGMMA_TILES`, no wider than Co, that pulls
    the fewest bytes while launching at least :data:`MIN_BLOCKS` blocks;
    where none launches that many (small images), the one that launches
    the most."""
    fits = [t for t in WGMMA_TILES if t[1] <= max(co, 64)]
    busy = [t for t in fits if _blocks(b, h, w, co, t) >= MIN_BLOCKS]
    if not busy:
        return max(fits, key=lambda t: _blocks(b, h, w, co, t))
    return min(busy, key=lambda t: _l2_bytes(b, h, w, ci, co, t))


def wgmma_grid(b: int, h: int, w: int, ci: int, co: int
               ) -> tuple[int, int, int]:
    """The wgmma kernel's launch grid (pixel tiles, Co tiles, images)."""
    th, bn = wgmma_tile(b, h, w, ci, co)
    return (math.ceil(h / th) * math.ceil(w / TILE_W), math.ceil(co / bn), b)


def direct_smem_bytes(tile) -> int:
    """The direct kernel's dynamic shared memory for ``tile``, in fp32: a
    ring of ``stages`` stages, each the (TH+2) x (TW+2) input halo of one
    chunk (a pixel's KC channels padded by 4 floats) and the chunk's 9 x
    KC x BN weight slice; after the ring, the same memory
    holds the partial tiles of ``split - 1`` thread groups."""
    th, tw, bn, kc, split, stages = tile
    ring = stages * ((th + 2) * (tw + 2) * (kc + 4) + 9 * kc * bn)
    return 4 * max(ring, (split - 1) * th * tw * bn)


def direct_grid(b: int, h: int, w: int, co: int, tile
                ) -> tuple[int, int, int]:
    """The direct kernel's launch grid for ``tile`` (pixel tiles, Co
    tiles, images); block (x, y, z) owns rows ``(x // ceil(W/TW)) * TH``,
    columns ``(x % ceil(W/TW)) * TW`` and channels ``y * BN`` onwards of
    image z."""
    th, tw, bn = tile[:3]
    return (math.ceil(h / th) * math.ceil(w / tw), math.ceil(co / bn), b)


def direct_cost(b: int, h: int, w: int, ci: int, co: int, tile) -> float:
    """The direct kernel's time with ``tile`` in SM clock cycles, as
    modelled: each SM takes ceil(blocks / 132) blocks in rounds of the
    tile's blocks per SM. A round lasts the longer of its FMA issue time
    (every warp's 768-FMA work units, 4 sub-partitions an SM issuing one
    warp instruction a cycle at the tile's relative speed) and one block's
    critical path (its warps' units at :data:`DIRECT_ONE_WARP_RATE`, plus
    :data:`DIRECT_CHUNK_CYCLES` a chunk)."""
    th, tw, bn, kc, split, _ = tile
    per_sm, speed = DIRECT_TILES[tile]
    warps = split * th * tw * bn // 64 // 32
    chunks = math.ceil(ci / kc)
    units = chunks * (3 * kc // 4) / split  # each warp's work units
    path = units * 768 / DIRECT_ONE_WARP_RATE + chunks * DIRECT_CHUNK_CYCLES
    left, cost = math.ceil(math.prod(direct_grid(b, h, w, co, tile))
                           / NUM_SMS), 0.0
    while left > 0:
        n = min(per_sm, left)
        left -= n
        cost += max(n * warps / 4 * units * 768 / speed, path)
    return cost


@functools.lru_cache(maxsize=None)
def direct_tile(b: int, h: int, w: int, ci: int, co: int
                ) -> tuple[int, int, int, int, int, int]:
    """The tile of :data:`DIRECT_TILES` no wider than Co with the least
    :func:`direct_cost`. The kernel is bound by its FMAs, so the L2-bytes
    rule of :func:`wgmma_tile` does not apply: on a full card the widest
    unsplit tile wins, and where the grid leaves SMs idle or one warp a
    sub-partition, split tiles and short chunks cut each block's critical
    path."""
    fits = [t for t in DIRECT_TILES if t[2] <= max(co, 64)]
    return min(fits, key=lambda t: direct_cost(b, h, w, ci, co, t))


def _check(what: str, x, co: int, w_shape, w, scale, bias, residual, x2,
           dtypes) -> None:
    """Device, dtype, shape and contiguity of a launch's operands."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: x must be {' or '.join(map(str, dtypes))},"
                        f" got {x.dtype}")
    b, h, wd, _ = x.shape
    for name, t in [("w", w)] + [(n, t) for n, t in (("x2", x2),
                                                     ("residual", residual))
                                 if t is not None]:
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}, x "
                            f"is {x.dtype} on {x.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype != torch.float32 or t.device != x.device
                or tuple(t.shape) != (co,)):
            raise TypeError(f"{what}: {name} must be fp32 [{co}] on "
                            f"{x.device}")
    if tuple(w.shape) != tuple(w_shape):
        raise ValueError(f"{what}: w {tuple(w.shape)} != {tuple(w_shape)}")
    if x2 is not None and tuple(x2.shape[:3]) != (b, h, wd):
        raise ValueError(f"{what}: x2 {tuple(x2.shape)} vs x "
                         f"{tuple(x.shape)}")
    if residual is not None and tuple(residual.shape) != (b, h, wd, co):
        raise ValueError(f"{what}: residual {tuple(residual.shape)} != "
                         f"{(b, h, wd, co)}")
    tensors = [x, w, scale, bias] + [t for t in (x2, residual)
                                     if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: all operands must be contiguous "
                         "(NHWC / HWIO / packed)")


def _launch(fn_name: str, what: str, x, w, scale, bias, relu, residual, x2,
            co: int, *tile: int) -> torch.Tensor:
    b, h, wd, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    out = torch.empty((b, h, wd, co), dtype=x.dtype, device=x.device)
    fn = getattr(build.load_library(), fn_name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), None if x2 is None else x2.data_ptr(),
                    w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    None if residual is None else residual.data_ptr(),
                    out.data_ptr(), b, h, wd, c1, c2, co, int(relu), *tile,
                    stream)
    build.check(status, what)
    return out


def conv3x3_bn_relu_wgmma(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          relu: bool = True,
                          residual: torch.Tensor | None = None,
                          x2: torch.Tensor | None = None,
                          tile: tuple[int, int] | None = None
                          ) -> torch.Tensor:
    """The tensor-core kernel ``csrc/conv3x3_wgmma.cu``: bf16 operands, w
    packed ``[9*Co, C1+C2]``, shapes that :func:`conv_variant` sends to
    "wgmma", every pointer 16-byte aligned (TMA's rule). ``tile`` (TH, BN)
    overrides :func:`wgmma_tile`'s pick. Raises on anything else; a CPU
    tensor takes the twin."""
    what = "conv3x3_bn_relu_wgmma"
    if residual is not None and x2 is not None:
        raise ValueError(f"{what}: residual and x2 are never combined")
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, unpack_weight(w), scale, bias, relu,
                                     residual, x2)
    if w.dim() != 2:
        raise ValueError(f"{what}: w must be packed [9*Co, Ci], got "
                         f"{tuple(w.shape)}")
    c1 = x.shape[-1]
    c2 = 0 if x2 is None else x2.shape[-1]
    co = w.shape[0] // 9
    _check(what, x, co, (9 * co, c1 + c2), w, scale, bias, residual, x2,
           (torch.bfloat16,))
    if conv_variant(x.dtype, c1, c2, co) != "wgmma":
        raise ValueError(f"{what}: C1={c1}, C2={c2}, Co={co} are not "
                         "multiples of 64, 64 and 8")
    for name, t in (("x", x), ("x2", x2), ("w", w), ("residual", residual),
                    ("scale", scale), ("bias", bias)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned "
                             "(TMA needs it)")
    if tile is None:
        b, h, wd, _ = x.shape
        tile = wgmma_tile(b, h, wd, c1 + c2, co)
    elif tuple(tile) not in WGMMA_TILES:
        raise ValueError(f"{what}: tile {tile} is not one of {WGMMA_TILES}")
    out = _launch("ws_conv3x3_wgmma_bf16", what, x, w, scale, bias, relu,
                  residual, x2, co, *tile)
    conv3x3_bn_relu_wgmma.launches += 1
    return out


conv3x3_bn_relu_wgmma.launches = 0


def conv3x3_bn_relu_direct(x: torch.Tensor, w: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           relu: bool = True,
                           residual: torch.Tensor | None = None,
                           x2: torch.Tensor | None = None,
                           tile: tuple[int, ...] | None = None
                           ) -> torch.Tensor:
    """The FMA kernel ``csrc/conv3x3.cu``: fp32 or bf16, w HWIO, any
    channel counts. ``tile`` (one of :data:`DIRECT_TILES`) overrides
    :func:`direct_tile`'s pick. A CPU tensor takes the twin."""
    what = "conv3x3_bn_relu_direct"
    if residual is not None and x2 is not None:
        raise ValueError(f"{what}: residual and x2 are never combined")
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, scale, bias, relu, residual, x2)
    fns = {torch.float32: "ws_conv3x3_bn_act_f32",
           torch.bfloat16: "ws_conv3x3_bn_act_bf16"}
    c1 = x.shape[-1]
    c2 = 0 if x2 is None else x2.shape[-1]
    co = w.shape[-1]
    _check(what, x, co, (3, 3, c1 + c2, co), w, scale, bias, residual, x2,
           tuple(fns))
    if tile is None:
        b, h, wd, _ = x.shape
        tile = direct_tile(b, h, wd, c1 + c2, co)
    elif tuple(tile) not in DIRECT_TILES:
        raise ValueError(f"{what}: tile {tile} is not one of {DIRECT_TILES}")
    out = _launch(fns[x.dtype], what, x, w, scale, bias, relu, residual, x2,
                  co, *tile)
    conv3x3_bn_relu_direct.launches += 1
    return out


conv3x3_bn_relu_direct.launches = 0

# the wrapper of each variant of :func:`conv_variant`
KERNELS = {"wgmma": conv3x3_bn_relu_wgmma, "direct": conv3x3_bn_relu_direct}


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, relu: bool = True,
                    residual: torch.Tensor | None = None,
                    x2: torch.Tensor | None = None) -> torch.Tensor:
    """y = [relu](conv3x3_same_s1(concat([x, x2]), w) * scale + bias
    [+ residual]), NHWC.

    x [B,H,W,C1] and optional x2 [B,H,W,C2] (bf16 or fp32), w HWIO
    [3,3,C1+C2,Co] in x's dtype, scale/bias [Co] fp32, optional residual
    [B,H,W,Co]. A CUDA tensor launches the kernel that :func:`conv_variant`
    names, with the weight re-laid by :func:`kernel_weight` on every call
    (a caller that repeats a weight prepares it once and calls
    :data:`KERNELS` itself); a CPU tensor takes
    :func:`conv3x3_bn_relu_plain`.
    """
    if residual is not None and x2 is not None:
        raise ValueError("conv3x3_bn_relu: residual and x2 are never combined")
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, scale, bias, relu, residual, x2)
    c2 = 0 if x2 is None else x2.shape[-1]
    variant = conv_variant(x.dtype, x.shape[-1], c2, w.shape[-1])
    return KERNELS[variant](x, kernel_weight(w, variant), scale, bias, relu,
                            residual, x2)


def fused_conv_eligible(x_shape, kernel: int, stride: int,
                        groups: int = 1) -> bool:
    """3x3, stride 1, groups 1, at least 8 input channels (not the RGB
    stem), at least 8x8, and a height with a divisor in {16, 14, 8, 7, 4}:
    the JAX gate's ``_pick_bh(h) >= 4`` term, kept so that both packages
    fuse the same convs (7x7 layer4 and awkward heights stay unfused)."""
    if kernel != 3 or stride != 1 or groups != 1:
        return False
    _, h, w, ci = x_shape
    return (ci >= 8 and h >= 8 and w >= 8
            and any(h % bh == 0 for bh in (16, 14, 8, 7, 4)))


_MODE = "auto"  # "auto": bf16 and fp32 CUDA tensors | "on" | "off"


def set_fused_conv_mode(mode: str) -> None:
    """"auto" (default) fuses bf16 and fp32 tensors on the card -- fp32
    through the direct kernel, not cuDNN's convolutions as in the JAX
    package's "auto" (see the module docstring) -- and nothing on the CPU;
    "on" and "off" force it (on a CPU tensor "on" runs the plain twin;
    "off" leaves every site to the library conv, cuDNN on the card)."""
    global _MODE
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused conv mode must be auto/on/off, got {mode!r}")
    _MODE = mode


def fused_conv_active(x_shape, dtype: torch.dtype, device: torch.device,
                      kernel: int, stride: int, groups: int = 1) -> bool:
    if _MODE == "off" or not fused_conv_eligible(x_shape, kernel, stride,
                                                 groups):
        return False
    if _MODE == "on":
        return True
    return device.type == "cuda" and dtype in (torch.bfloat16,
                                               torch.float32)
