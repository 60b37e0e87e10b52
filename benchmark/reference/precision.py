"""The arithmetic of the plain reference: fp32 with TF32 off, or one of
the lower precisions that serve as the correctness control.

``fp32``: float32 everywhere, TF32 off for cuDNN and matmuls.
``tf32``: the same code with TF32 on (the control of an fp32 config).
``fp8``: every convolution, linear map and attention product rounds its
inputs, its weight and its result to float8 e4m3, each with a per-tensor
scale, and the observations and the carried state are rounded as they
enter (the control of a bf16 config); the sums themselves stay in
float32, as fp8 hardware accumulates.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3 value

_mode = "fp32"


def mode() -> str:
    return _mode


@contextlib.contextmanager
def arithmetic(name: str):
    """Run the block in precision ``name`` (one of :data:`MODES`)."""
    global _mode
    if name not in MODES:
        raise ValueError(f"precision {name!r}, expected one of {MODES}")
    old = (_mode, torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    _mode = name
    torch.backends.cudnn.allow_tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        (_mode, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def q(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the current precision holds it: unchanged, except under
    ``fp8``, where it is rounded to e4m3 at a per-tensor scale."""
    if _mode != "fp8" or not t.is_floating_point():
        return t
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def conv2d(x, w, b=None, stride=1, padding=0):
    return q(F.conv2d(q(x), q(w), b, stride, padding))


def conv_transpose2d(x, w, b=None, stride=1, padding=0):
    return q(F.conv_transpose2d(q(x), q(w), b, stride, padding))


def linear(x, w, b=None):
    return q(F.linear(q(x), q(w), b))


def matmul(a, b):
    return q(q(a) @ q(b))
