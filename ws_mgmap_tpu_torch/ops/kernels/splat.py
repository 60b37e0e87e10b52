"""Ground-plane scatter-max splat: the CUDA kernel's wrapper and its twin.

Port of ``ws_mgmap_tpu/ops/pallas/splat.py::splat_pallas`` (and of
``splat_pallas_packed``, which computes the same function). The kernel is
``csrc/splat.cu``; :func:`splat_max_plain` is its plain PyTorch twin.
"""
from __future__ import annotations

import torch

from ws_mgmap_tpu_torch.ops.kernels import build

EPS_INVALID = -1e16


def splat_max_plain(feats: torch.Tensor, ids: torch.Tensor,
                    ego_size: int) -> torch.Tensor:
    """feats [B, P, C] fp32/bf16, ids [B, P] int32 with -1 at invalid
    pixels -> [B, E, E, C] fp32: the per-cell max, 0 where no valid pixel
    landed or the max is <= -1e16."""
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


def splat_max(feats: torch.Tensor, ids: torch.Tensor,
              ego_size: int) -> torch.Tensor:
    """Same contract as :func:`splat_max_plain`. A CUDA tensor launches
    ``csrc/splat.cu``; a CPU tensor takes the plain twin."""
    if feats.device.type == "cpu":
        return splat_max_plain(feats, ids, ego_size)
    if feats.device.type != "cuda" or ids.device != feats.device:
        raise ValueError(f"splat_max: feats on {feats.device}, ids on "
                         f"{ids.device}; both must be on one CUDA device")
    if feats.dim() != 3 or ids.shape != feats.shape[:2]:
        raise ValueError(f"splat_max: feats {tuple(feats.shape)} must be "
                         f"[B, P, C] and ids {tuple(ids.shape)} [B, P]")
    if ids.dtype != torch.int32:
        raise TypeError(f"splat_max: ids must be int32, got {ids.dtype}")
    fns = {torch.float32: "ws_splat_max_f32",
           torch.bfloat16: "ws_splat_max_bf16"}
    if feats.dtype not in fns:
        raise TypeError(f"splat_max: feats must be fp32 or bf16, got "
                        f"{feats.dtype}")
    if not (feats.is_contiguous() and ids.is_contiguous()):
        raise ValueError("splat_max: feats and ids must be contiguous")
    b, p, c = feats.shape
    cells = ego_size * ego_size
    out = torch.empty((b, ego_size, ego_size, c), dtype=torch.float32,
                      device=feats.device)
    fn = getattr(build.load_library(), fns[feats.dtype])
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(feats.data_ptr(), ids.data_ptr(), out.data_ptr(), b, p, c,
                    cells, stream)
    build.check(status, "splat_max")
    splat_max.launches += 1
    return out


splat_max.launches = 0
