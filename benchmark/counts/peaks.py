"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit) and the least time a piece of work could take
on it."""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # fp32: outside the tensor cores
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float, dtype: str) -> dict:
    """The larger of the bytes over the memory rate and the operations
    over the type's peak rate, in seconds, and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return {"bound_s": max(t_bytes, t_ops), "bytes_s": t_bytes,
            "ops_s": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
