"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, raise instead of silently
    running on the CPU: the caller must ask for ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
