"""2-D diagonal Gaussian waypoint head and the critic.

Port of ``ws_mgmap_tpu/models/distributions.py``: mean = Linear(features),
log-std a learned state-independent bias (``logstd._bias`` [A, 1], zero
at init); ``mode`` is the mean, ``log_probs`` sums over the action dim.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn

from ws_mgmap_tpu_torch.models.layers import tdense


class Normal2D(NamedTuple):
    mean: torch.Tensor  # [B, A]
    logstd: torch.Tensor  # [B, A]

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """mean + N(0, 1) * std, the noise drawn from ``generator`` (on
        the mean's device)."""
        eps = torch.randn(self.mean.shape, generator=generator,
                          device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + eps * torch.exp(self.logstd)

    def log_probs(self, actions: torch.Tensor) -> torch.Tensor:
        var = torch.exp(2.0 * self.logstd)
        lp = (-0.5 * ((actions - self.mean) ** 2 / var) - self.logstd
              - 0.5 * math.log(2.0 * math.pi))
        return lp.sum(-1)

    def entropy(self) -> torch.Tensor:
        return (self.logstd + 0.5 * math.log(2.0 * math.pi * math.e)).sum(-1)


class AddBias(nn.Module):
    """The reference's ``AddBias``: a ``_bias`` parameter of shape [A, 1]."""

    def __init__(self, n: int):
        super().__init__()
        self._bias = nn.Parameter(torch.zeros(n, 1))


class DiagGaussian(nn.Module):
    def __init__(self, num_inputs: int, num_outputs: int = 2):
        super().__init__()
        self.fc_mean = tdense(num_inputs, num_outputs)
        self.logstd = AddBias(num_outputs)

    def forward(self, x: torch.Tensor) -> Normal2D:
        mean = self.fc_mean(x)
        return Normal2D(mean, self.logstd._bias.reshape(1, -1).expand_as(mean))


class CriticHead(nn.Module):
    """habitat ``CriticHead``: Linear(h, 1), orthogonal weight, zero bias."""

    def __init__(self, num_inputs: int):
        super().__init__()
        self.fc = nn.Linear(num_inputs, 1)
        nn.init.orthogonal_(self.fc.weight)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)
