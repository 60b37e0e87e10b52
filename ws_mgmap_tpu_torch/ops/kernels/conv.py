"""Fused 3x3 conv + folded BN (+ residual) (+ ReLU): wrapper, twin and gate.

Port of ``ws_mgmap_tpu/ops/pallas/conv.py``: :func:`fold_bn`,
:func:`conv3x3_bn_relu` (kernel ``csrc/conv3x3.cu``; plain twin
:func:`conv3x3_bn_relu_plain`) and the gate that decides where the UNet
uses it (:func:`fused_conv_eligible`, :func:`set_fused_conv_mode`,
:func:`fused_conv_active`). All tensors are NHWC; weights are HWIO.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ws_mgmap_tpu_torch.ops.kernels import build


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


def conv3x3_bn_relu_plain(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          relu: bool = True,
                          residual: torch.Tensor | None = None,
                          x2: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: ``F.conv2d`` over the
    channel concat in fp32, ``* scale + bias``, ``+ residual``, ReLU, then
    the input dtype."""
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


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, relu: bool = True,
                    residual: torch.Tensor | None = None,
                    x2: torch.Tensor | None = None) -> torch.Tensor:
    """y = [relu](conv3x3_same_s1(concat([x, x2]), w) * scale + bias
    [+ residual]), NHWC.

    x [B,H,W,C1] and optional x2 [B,H,W,C2] (bf16 or fp32), w
    [3,3,C1+C2,Co] HWIO in x's dtype, scale/bias [Co] fp32, optional
    residual [B,H,W,Co]. A CUDA tensor launches ``csrc/conv3x3.cu``; a CPU
    tensor takes :func:`conv3x3_bn_relu_plain`.
    """
    if residual is not None and x2 is not None:
        raise ValueError("conv3x3_bn_relu: residual and x2 are never combined")
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, scale, bias, relu, residual, x2)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: unsupported device {x.device}")
    fns = {torch.float32: "ws_conv3x3_bn_act_f32",
           torch.bfloat16: "ws_conv3x3_bn_act_bf16"}
    if x.dtype not in fns:
        raise TypeError(f"conv3x3_bn_relu: x must be fp32 or bf16, got "
                        f"{x.dtype}")
    b, h, wd, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    co = w.shape[-1]
    same_dtype = [("w", w)] + [(n, t) for n, t in (("x2", x2),
                                                   ("residual", residual))
                               if t is not None]
    for name, t in same_dtype:
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"conv3x3_bn_relu: {name} is {t.dtype} on "
                            f"{t.device}, x is {x.dtype} on {x.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype != torch.float32 or t.device != x.device
                or tuple(t.shape) != (co,)):
            raise TypeError(f"conv3x3_bn_relu: {name} must be fp32 [{co}] on "
                            f"{x.device}")
    if tuple(w.shape) != (3, 3, c1 + c2, co):
        raise ValueError(f"conv3x3_bn_relu: w {tuple(w.shape)} != "
                         f"(3, 3, {c1 + c2}, {co})")
    if x2 is not None and tuple(x2.shape[:3]) != (b, h, wd):
        raise ValueError(f"conv3x3_bn_relu: x2 {tuple(x2.shape)} vs x "
                         f"{tuple(x.shape)}")
    if residual is not None and tuple(residual.shape) != (b, h, wd, co):
        raise ValueError(f"conv3x3_bn_relu: residual {tuple(residual.shape)} "
                         f"!= {(b, h, wd, co)}")
    tensors = [x, w, scale, bias] + [t for t in (x2, residual)
                                     if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3_bn_relu: all operands must be contiguous "
                         "(NHWC / HWIO)")
    out = torch.empty((b, h, wd, co), dtype=x.dtype, device=x.device)
    fn = getattr(build.load_library(), fns[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), None if x2 is None else x2.data_ptr(),
                    w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    None if residual is None else residual.data_ptr(),
                    out.data_ptr(), b, h, wd, c1, c2, co, int(relu), stream)
    build.check(status, "conv3x3_bn_relu")
    conv3x3_bn_relu.launches += 1
    return out


conv3x3_bn_relu.launches = 0


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


_MODE = "auto"  # "auto": bf16 CUDA tensors only | "on" | "off"


def set_fused_conv_mode(mode: str) -> None:
    """"auto" (default) fuses only bf16 tensors on the card -- the fp32
    parity path keeps the library conv, as in the JAX package; "on" and
    "off" force it (on a CPU tensor "on" runs the plain twin)."""
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
    return device.type == "cuda" and dtype == torch.bfloat16
