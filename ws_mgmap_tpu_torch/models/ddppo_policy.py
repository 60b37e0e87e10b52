"""DD-PPO PointNav local controller (frozen, eval-time).

Port of ``ws_mgmap_tpu/models/ddppo_policy.py``, a re-design of
`DdppoPolicy` (`vlnce_baselines/models/ddppo_policy.py:14-81`): habitat's
`PointNavResNetPolicy` — GroupNorm ResNet50 over depth (the depth
encoder's trunk at spatial size 128), target (rho, phi) embedding,
previous-action embedding, 2-layer LSTM core, categorical head over
{STOP, FORWARD, LEFT, RIGHT}. Keys are habitat's; a checkpoint such as
``gibson-4plus-mp3d-train-val-test-resnet50.pth`` loads under the
``actor_critic.`` prefix.

The controller converts the high-level policy's waypoint into discrete sim
actions during evaluation (`action_maker.py:47-124`). It reaches no kernel
of the port: the trunk is GroupNorm, which has no fused-conv gate.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ws_mgmap_tpu_torch.models.depth_encoder import ResNetEncoder
from ws_mgmap_tpu_torch.models.rnn import StackedLSTM
from ws_mgmap_tpu_torch.utils.convert import load_torch_checkpoint
from ws_mgmap_tpu_torch.utils.device import resolve_device

CHECKPOINT_PREFIX = "actor_critic."


class StateEncoder(nn.Module):
    """habitat's ``RNNStateEncoder`` with an LSTM (keys ``rnn.*``)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.rnn = StackedLSTM(input_size, hidden_size, num_layers)


class PointNavResNetNet(nn.Module):
    """habitat `PointNavResNetNet` (hidden 512, LSTM-2, resnet50)."""

    def __init__(self, hidden_size: int = 512, num_actions: int = 4,
                 num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        self.visual_encoder = ResNetEncoder(spatial_size=128)
        self.visual_fc = nn.Sequential(
            nn.Flatten(), nn.Linear(2048, hidden_size), nn.ReLU())
        # goal input: [rho, cos(-phi), sin(-phi)]
        self.tgt_embeding = nn.Linear(3, 32)
        self.prev_action_embedding = nn.Embedding(num_actions + 1, 32)
        self.state_encoder = StateEncoder(hidden_size + 32 + 32, hidden_size,
                                          num_layers)

    def forward(self, depth: torch.Tensor, pointgoal: torch.Tensor,
                prev_actions: torch.Tensor, hidden: torch.Tensor,
                masks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """depth [B,256,256,1] (NHWC), pointgoal [B,2] (rho, phi),
        prev_actions [B] int, hidden [2*num_layers, B, H] (h rows then c
        rows), masks [B,1]. Returns (features [B,H], new_hidden)."""
        rho, phi = pointgoal[:, 0], pointgoal[:, 1]
        goal = torch.stack([rho, torch.cos(-phi), torch.sin(-phi)], -1)
        tgt = self.tgt_embeding(goal)

        # truncated toward zero, as JAX's astype(int32)
        prev_idx = ((prev_actions.float() + 1.0) * masks.reshape(-1)).long()
        prev = self.prev_action_embedding(prev_idx)

        vis = self.visual_encoder(depth.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        vis = self.visual_fc(vis)  # flattens NCHW, as habitat does

        x = torch.cat([vis, tgt, prev], 1)
        m = masks.reshape(-1, 1)
        n = self.num_layers
        x, h, c = self.state_encoder.rnn(x, hidden[:n] * m, hidden[n:] * m)
        return x, torch.cat([h, c], 0)


class CategoricalNet(nn.Module):
    """habitat's action head: ``linear`` to the logits."""

    def __init__(self, hidden_size: int, num_actions: int):
        super().__init__()
        self.linear = nn.Linear(hidden_size, num_actions)


class CriticHead(nn.Module):
    """habitat's value head: ``fc`` to one value."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.fc = nn.Linear(hidden_size, 1)


class PointNavResNetPolicy(nn.Module):
    def __init__(self, hidden_size: int = 512, num_actions: int = 4):
        super().__init__()
        self.net = PointNavResNetNet(hidden_size, num_actions)
        self.action_distribution = CategoricalNet(hidden_size, num_actions)
        self.critic = CriticHead(hidden_size)

    def act(self, depth, pointgoal, prev_actions, hidden, masks):
        """-> (argmax action [B], logits [B, 4], value [B, 1], hidden)."""
        feats, hidden = self.net(depth, pointgoal, prev_actions, hidden,
                                 masks)
        logits = self.action_distribution.linear(feats)
        value = self.critic.fc(feats)
        return logits.argmax(-1), logits, value, hidden


def random_init_(module: nn.Module, gen: torch.Generator) -> None:
    """torch's default initialisation, drawn from ``gen``: convs and
    linears U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
    embeddings N(0, 1), LSTMs U(-1/sqrt(H), 1/sqrt(H)); GroupNorm keeps
    its ones and zeros."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(generator=gen)
            elif isinstance(m, StackedLSTM):
                bound = 1.0 / math.sqrt(m.weight_hh_l0.shape[1])
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=gen)


class DdppoController:
    """Host-side stateful adapter mirroring `DdppoPolicy.plan/reset`
    (`ddppo_policy.py:57-81`); one instance per env.

    ``state_dict``: the policy's weights, loaded strictly; without them a
    random init drawn from a ``torch.Generator`` seeded with ``seed``.
    ``device``: the card unless ``"cpu"`` (env workers pass ``"cpu"``)."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, hidden_size: int = 512, device=None):
        self.device = resolve_device(device)
        self.hidden_size = hidden_size
        self.policy = PointNavResNetPolicy(hidden_size)
        if state_dict is None:
            random_init_(self.policy, torch.Generator().manual_seed(seed))
        else:
            self.policy.load_state_dict(state_dict, strict=True)
        self.policy.to(self.device).eval().requires_grad_(False)
        self.reset()

    @classmethod
    def from_torch_checkpoint(cls, path: str, device=None
                              ) -> "DdppoController":
        """A habitat DD-PPO checkpoint: the keys under ``actor_critic.``,
        the prefix taken off, fill every parameter."""
        raw = load_torch_checkpoint(path)
        sd = {k[len(CHECKPOINT_PREFIX):]: v for k, v in raw.items()
              if k.startswith(CHECKPOINT_PREFIX)}
        return cls(sd, device=device)

    def reset(self):
        n = 2 * self.policy.net.num_layers
        self.hidden = torch.zeros((n, 1, self.hidden_size),
                                  device=self.device)
        self.prev_action = torch.zeros((1,), dtype=torch.int64,
                                       device=self.device)

    def plan(self, depth, pointgoal, t: int) -> int:
        """depth [256,256,1] (or [H,W]), pointgoal [2] (rho, phi)."""
        d = torch.from_numpy(
            np.asarray(depth, np.float32).reshape(1, 256, 256, 1))
        g = torch.from_numpy(np.asarray(pointgoal, np.float32).reshape(1, 2))
        masks = torch.full((1, 1), 0.0 if t == 0 else 1.0)
        with torch.no_grad():
            action, _, _, self.hidden = self.policy.act(
                d.to(self.device), g.to(self.device), self.prev_action,
                self.hidden, masks.to(self.device))
        self.prev_action = action
        return int(action[0])
