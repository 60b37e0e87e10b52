"""Ground-plane scatter-max splat: the CUDA kernel's wrapper and its twin.

Port of ``ws_mgmap_tpu/ops/pallas/splat.py::splat_pallas`` (and of
``splat_pallas_packed``, which computes the same function). The kernel is
``csrc/splat.cu``: one launch, each frame's accumulator held in the shared
memory of ``RANKS`` blocks, cut into channel groups by :func:`splat_plan`;
:func:`splat_max_plain` is its plain PyTorch twin.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ws_mgmap_tpu_torch.ops.kernels import build

EPS_INVALID = -1e16
RANKS = 8  # blocks per (frame, channel group): a portable cluster
SMEM_BUDGET = 232_448  # bytes of shared memory a block may use on an H100
MAX_GROUP = 32  # a warp's lanes are a channel group's channels
# csrc/splat.cu's other shared memory: the list of pixels to merge (2
# rounds of 8 ids x 512 threads, 4 bytes each) and each of its 16 warps'
# 2 KB stage of feature rows (tests/test_torch_kernels.py holds
# SplatPlan.smem_bytes against the built kernel's own figure)
LIST_AND_STAGE_BYTES = 2 * 8 * 512 * 4 + 16 * 2048


@dataclass(frozen=True)
class SplatPlan:
    """How ``csrc/splat.cu`` cuts one frame: rank r of ``RANKS`` owns cells
    r, r + RANKS, ...; each of the ``n_groups`` channel groups (``group``
    wide, the last one narrower) is a block per rank, holding a row of
    ``group`` fp32 keys for each of its ``cells_per_rank`` cells and a list
    of pixels."""
    cells_per_rank: int
    group: int
    n_groups: int

    @property
    def smem_bytes(self) -> int:
        """The block's dynamic shared memory, as ``ws_splat_smem_bytes``
        reports it for the same plan."""
        return -(-self.cells_per_rank * self.group // 4) * 16 + LIST_AND_STAGE_BYTES


def splat_plan(ego_size: int, channels: int) -> SplatPlan:
    """The fewest channel groups, of at most ``MAX_GROUP`` channels, whose
    keys and list fit in ``SMEM_BUDGET`` bytes of shared memory per
    block."""
    cpr = -(-ego_size * ego_size // RANKS)
    # 16 bytes for the list's count and the keys' padding
    fits = (SMEM_BUDGET - LIST_AND_STAGE_BYTES - 16) // (4 * cpr)
    if fits < 1:
        raise ValueError(f"splat_plan: an ego grid of {ego_size}^2 needs "
                         f"more than {SMEM_BUDGET} bytes per block")
    n_groups = -(-channels // min(channels, fits, MAX_GROUP))
    group = -(-channels // n_groups)
    return SplatPlan(cells_per_rank=cpr, group=group,
                     n_groups=-(-channels // group))


def splat_smem_bytes(plan: SplatPlan) -> int:
    """The dynamic shared memory per block that the built kernel asks for
    with this plan (``ws_splat_smem_bytes``)."""
    return build.load_library().ws_splat_smem_bytes(plan.cells_per_rank,
                                                    plan.group)


def splat_max_plain(feats: torch.Tensor, ids: torch.Tensor,
                    ego_size: int) -> torch.Tensor:
    """feats [B, P, C] fp32/bf16, ids [B, P] int32 with -1 at invalid
    pixels -> [B, E, E, C] fp32: the per-cell max, 0 where no valid pixel
    landed or the max is <= -1e16; NaN propagates."""
    b, p, c = feats.shape
    cells = ego_size * ego_size
    # invalid pixels go to a trash row past the real cells
    idx = torch.where(ids < 0, cells, ids).to(torch.int64)
    out = torch.full((b, cells + 1, c), float("-inf"), dtype=torch.float32,
                     device=feats.device)
    out.scatter_reduce_(1, idx[:, :, None].expand(b, p, c),
                        feats.to(torch.float32), "amax", include_self=False)
    out = out[:, :cells]
    out = torch.where(out <= EPS_INVALID, 0.0, out)
    return out.reshape(b, ego_size, ego_size, c)


def _operands(feats: torch.Tensor, ids: torch.Tensor,
              ego_size: int) -> SplatPlan:
    """Check what the kernel takes and plan it; raises on anything else."""
    if feats.device.type != "cuda" or ids.device != feats.device:
        raise ValueError(f"splat_max: feats on {feats.device}, ids on "
                         f"{ids.device}; both must be on one CUDA device")
    if feats.dim() != 3 or ids.shape != feats.shape[:2]:
        raise ValueError(f"splat_max: feats {tuple(feats.shape)} must be "
                         f"[B, P, C] and ids {tuple(ids.shape)} [B, P]")
    if ids.dtype != torch.int32:
        raise TypeError(f"splat_max: ids must be int32, got {ids.dtype}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"splat_max: feats must be fp32 or bf16, got "
                        f"{feats.dtype}")
    if not (feats.is_contiguous() and ids.is_contiguous()):
        raise ValueError("splat_max: feats and ids must be contiguous")
    if feats.shape[0] < 1 or feats.shape[2] < 1 or ego_size < 1:
        raise ValueError(f"splat_max: empty batch, channels or grid: feats "
                         f"{tuple(feats.shape)}, ego_size {ego_size}")
    return splat_plan(ego_size, feats.shape[2])


def splat_max(feats: torch.Tensor, ids: torch.Tensor,
              ego_size: int) -> torch.Tensor:
    """Same contract as :func:`splat_max_plain` (ids outside [0, E^2) are
    skipped). A CUDA tensor launches ``csrc/splat.cu`` once; a CPU tensor
    takes the plain twin."""
    if feats.device.type == "cpu":
        return splat_max_plain(feats, ids, ego_size)
    plan = _operands(feats, ids, ego_size)
    b, p, c = feats.shape
    out = torch.empty((b, ego_size, ego_size, c), dtype=torch.float32,
                      device=feats.device)
    lib = build.load_library()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ws_splat_max(
            feats.data_ptr(), ids.data_ptr(), out.data_ptr(), b, p, c,
            ego_size * ego_size, plan.cells_per_rank, plan.group,
            int(feats.dtype == torch.bfloat16), stream)
    build.check(status, "splat_max")
    splat_max.launches += 1
    return out


splat_max.launches = 0


def splat_active_clusters(feats: torch.Tensor, ids: torch.Tensor,
                          ego_size: int) -> int:
    """How many of the kernel's clusters for these operands fit on the
    card at once (``cudaOccupancyMaxActiveClusters``)."""
    plan = _operands(feats, ids, ego_size)
    n = ctypes.c_int(0)
    with torch.cuda.device(feats.device):
        status = build.load_library().ws_splat_max_active_clusters(
            feats.shape[0], feats.shape[2], ego_size * ego_size,
            plan.cells_per_rank, plan.group,
            int(feats.dtype == torch.bfloat16), ctypes.addressof(n))
    build.check(status, "splat_active_clusters")
    return n.value
