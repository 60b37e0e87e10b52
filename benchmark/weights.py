"""Random weights of the WS-MGMap policy, made on the device from the
seed in two large draws (one uniform, one normal), then cut into leaves.

Scales: a convolution's weight is uniform with He's bound sqrt(6 /
fan_in), so activations keep their size through the ReLU trunks; a
linear, recurrent or 1x1 key layer's weight is uniform in +-1/sqrt(fan_in)
(torch's default); embeddings are N(0, 1); layer biases are uniform in
+-0.1. BatchNorm gets scales in [0.5, 1], shifts in [0.05, 0.3] (mostly
non-zero features after each ReLU), running means N(0, 0.05^2) and
running variances in [0.5, 1.5]; GroupNorm scales in [0.5, 1] and shifts
in +-0.1.
"""
from __future__ import annotations

import math

import torch


def _kind(name: str, shape, sd_shapes: dict) -> str:
    base = name.rsplit(".", 1)[0]
    if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
        return name.rsplit(".", 1)[1]
    is_bn = base + ".running_mean" in sd_shapes
    if "embedding" in name:
        return "embedding"
    if len(shape) == 1:
        sibling = sd_shapes.get(base + ".weight")
        norm = sibling is not None and len(sibling) == 1
        if name.endswith(".weight"):
            return "bn_weight" if is_bn else "gn_weight"
        if norm:
            return "bn_bias" if is_bn else "gn_bias"
        return "bias"
    if len(shape) == 4:
        return "conv"
    return "linear"


def make_state_dict(shapes: dict, seed: int, device,
                    transposed: tuple = ()) -> dict:
    """A state dict of the given shapes (name -> shape) on ``device``.
    ``transposed`` names the ConvTranspose weights ([in, out, kh, kw])."""
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    total = sum(sizes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = sizes[name]
        u = uni[at:at + n].view(shape)
        g = nrm[at:at + n].view(shape)
        at += n
        kind = _kind(name, shape, shapes)
        if kind == "conv":
            # a stride-2 transposed conv sums over a quarter of its taps
            fan_in = (shape[0] * shape[2] * shape[3] // 4 if name in transposed
                      else shape[1] * shape[2] * shape[3])
            t = (u * 2 - 1) * math.sqrt(6.0 / fan_in)
        elif kind == "linear":
            fan_in = math.prod(shape[1:])
            t = (u * 2 - 1) / math.sqrt(fan_in)
        elif kind == "embedding":
            t = g
        elif kind == "bias":
            t = (u * 2 - 1) * 0.1
        elif kind in ("bn_weight", "gn_weight"):
            t = u * 0.5 + 0.5
        elif kind == "bn_bias":
            t = u * 0.25 + 0.05
        elif kind == "gn_bias":
            t = (u * 2 - 1) * 0.1
        elif kind == "running_mean":
            t = g * 0.05
        elif kind == "running_var":
            t = u + 0.5
        else:  # num_batches_tracked
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        out[name] = t.clone()
    return out
