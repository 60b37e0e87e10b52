"""Minimal observation/action space descriptors (gym is not a dependency).

The port's copy of ``ws_mgmap_tpu/env/spaces.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Box:
    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: type = np.float32


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int


class DictSpace(dict):
    """Named sub-spaces; dict with attribute-style `.spaces`."""

    @property
    def spaces(self) -> Dict[str, object]:
        return self


# The policy's continuous waypoint action space
# (`common/env_utils.py:79-80`).
WAYPOINT_ACTION_SPACE = Box(low=0.0, high=0.99, shape=(2,))
