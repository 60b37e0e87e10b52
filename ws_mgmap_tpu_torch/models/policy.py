"""MGMapNet + BasePolicy: the cross-modal waypoint policy.

Port of ``ws_mgmap_tpu/models/policy.py``: the configuration, the
per-frame encoders (UNet, mapping step, depth ResNet50, map encoder /
decoder / classifier, instruction biLSTM), the recurrent core (GRU1 ->
text attention -> map attention -> GRU2) and the heads, for the decision
step (``act``), the map-only step (``update_map``) and teacher forcing
over episode-major batches (``forward_seq``). Train mode
(``policy.train()``) puts the map modules' BatchNorm on batch statistics,
as JAX's ``train=True`` does; the UNet stays in eval mode, as JAX always
runs it with ``train=False``. Module paths keep
the reference's torch keys (``net.rgb_encoder.…``,
``net.state_encoder.rnn.weight_ih_l0``, ``action_distribution.…``), so a
state_dict carries over by key. The hidden state is [2, B, H]: row 0 is
GRU1, row 1 GRU2. Observations, the ego map, ``pred_sem_map`` and the
cached features are NHWC, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ws_mgmap_tpu_torch.models.depth_encoder import VlnResnetDepthEncoder
from ws_mgmap_tpu_torch.models.distributions import CriticHead, DiagGaussian
from ws_mgmap_tpu_torch.models.instruction_encoder import InstructionEncoder
from ws_mgmap_tpu_torch.models.layers import tconv, tdense
from ws_mgmap_tpu_torch.models.map_modules import (MapClassifier, MapDecoder,
                                                   MapEncoder)
from ws_mgmap_tpu_torch.models.rnn import RNNStateEncoder
from ws_mgmap_tpu_torch.models.unet import UNet
from ws_mgmap_tpu_torch.ops.mapping import MapperParams, rgb_mapping_step
from ws_mgmap_tpu_torch.ops.pooling import avg_pool2d_nhwc


@dataclasses.dataclass(frozen=True)
class MGMapConfig:
    """Static model hyperparameters (reference ``config/default.py``)."""

    vocab_size: int = 2504
    embedding_size: int = 50
    instr_hidden: int = 128
    rgb_output_size: int = 256
    depth_output_size: int = 128
    # side of the depth trunk's output: 4 for 256^2 depth ((H/2)/32)
    depth_spatial: int = 4
    # UNet channel-width multiplier (1.0 = the reference architecture)
    unet_width: float = 1.0
    map_output_size: int = 256
    ego_map_size: int = 100
    map_depth: int = 64
    hidden_size: int = 512
    input_type: tuple[str, ...] = ("rgb", "depth", "map")
    num_classes: int = 27
    mapper: MapperParams = MapperParams()

    @classmethod
    def from_config(cls, model_cfg) -> "MGMapConfig":
        """From a yacs-like ``MODEL`` node, read by attribute."""
        m = model_cfg
        return cls(
            vocab_size=m.INSTRUCTION_ENCODER.vocab_size,
            embedding_size=m.INSTRUCTION_ENCODER.embedding_size,
            instr_hidden=m.INSTRUCTION_ENCODER.hidden_size,
            rgb_output_size=m.RGB_ENCODER.output_size,
            depth_output_size=m.DEPTH_ENCODER.output_size,
            depth_spatial=getattr(m.DEPTH_ENCODER, "spatial_hw", 4),
            unet_width=getattr(m.RGB_ENCODER, "unet_width", 1.0),
            map_output_size=m.MAP_ENCODER.output_size,
            ego_map_size=m.MAP_ENCODER.ego_map_size,
            map_depth=m.RGBMAPPING.map_depth,
            hidden_size=m.STATE_ENCODER.hidden_size,
            input_type=tuple(m.STATE_ENCODER.input_type),
            mapper=MapperParams(
                resolution=m.RGBMAPPING.resolution,
                ego_size=m.RGBMAPPING.egocentric_map_size,
                global_size=m.RGBMAPPING.global_map_size,
                map_depth=m.RGBMAPPING.map_depth,
                rotate_in_splat=getattr(m.RGBMAPPING, "rotate_in_splat",
                                        False),
            ),
        )

    @property
    def state_in_size(self) -> int:
        return ((self.rgb_output_size if "rgb" in self.input_type else 0)
                + (self.depth_output_size if "depth" in self.input_type
                   else 0)
                + (self.map_output_size if "map" in self.input_type else 0))

    @property
    def second_in_size(self) -> int:
        return self.hidden_size + self.hidden_size // 2 + (
            self.hidden_size // 2 if "map" in self.input_type else 0)


class FrameFeatures(NamedTuple):
    """Per-frame (non-recurrent) activations."""

    state_in: torch.Tensor        # [B, state_in_size]
    map_embedding: torch.Tensor   # [B, S=24*24, map_output_size]
    text: torch.Tensor            # [B, L, 2*instr_hidden]
    text_pad: torch.Tensor        # [B, L] bool, True at pads
    pred_sem_map: torch.Tensor    # [B, 48, 48, 27] logits, NHWC
    ego_map: torch.Tensor         # [B, E, E, map_depth]
    rgb_features: torch.Tensor | None = None    # UNet bottleneck [B,7,7,512]
    depth_features: torch.Tensor | None = None  # depth trunk [B,4,4,128]


def _k_layer(in_f: int, out_f: int) -> nn.Conv1d:
    """The reference's key layers: torch ``Conv1d(k=1)``, weight [out, in,
    1], applied here as the linear map it is."""
    return nn.Conv1d(in_f, out_f, 1)


def _attend(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
            scale: float, pad: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax((keys . q - pad * 1e8) * scale) over the sequence, and the
    weighted sum of ``values``: q [B, C], keys [B, L, C], values [B, L, V]
    -> ([B, V], weights [B, L])."""
    logits = (keys @ q[:, :, None])[..., 0]
    if pad is not None:
        logits = logits - pad.to(logits.dtype) * 1e8
    att = torch.softmax(logits * scale, dim=1)
    return (att[:, None, :] @ values)[:, 0], att


class MGMapNet(nn.Module):
    def __init__(self, cfg: MGMapConfig):
        super().__init__()
        self.cfg = cfg
        c, h = cfg, cfg.hidden_size
        self.instruction_encoder = InstructionEncoder(
            c.vocab_size, c.embedding_size, c.instr_hidden)
        self.rgb_encoder = UNet(width_mult=c.unet_width)
        self.depth_encoder = VlnResnetDepthEncoder(c.depth_spatial)
        # the reference's Sequentials, with their indices
        self.rgb_linear = nn.Sequential(
            nn.AdaptiveAvgPool1d(1), nn.Flatten(),
            tdense(max(8, int(512 * c.unet_width)), c.rgb_output_size),
            nn.ReLU())
        self.depth_linear = nn.Sequential(
            nn.Flatten(),
            tdense(192 * c.depth_spatial ** 2, c.depth_output_size),
            nn.ReLU())
        self.map_linear = nn.Sequential(
            nn.AdaptiveAvgPool1d(1), nn.Flatten(),
            tdense(c.map_output_size, c.map_output_size), nn.ReLU())
        self.map_encoder = MapEncoder(c.map_depth, c.map_output_size)
        self.map_decoder = MapDecoder(c.map_output_size)
        self.map_classfier = MapClassifier(c.num_classes)
        self.map_encoded_linear = nn.Sequential(
            tconv(c.map_output_size, 128, 3, 1, 1), nn.ReLU())
        self.map_classified_linear = nn.Sequential(
            tconv(c.num_classes, 128, 3, 1, 1), nn.ReLU())
        self.map_cated_linear = nn.Sequential(
            tconv(256, c.map_output_size, 3, 1, 1), nn.ReLU())
        self.state_encoder = RNNStateEncoder(c.state_in_size, h)
        self.second_state_encoder = RNNStateEncoder(h, h)
        self.state_text_q_layer = tdense(h, h // 2)
        self.state_text_k_layer = _k_layer(2 * c.instr_hidden, h // 2)
        self.text_map_q_layer = tdense(2 * c.instr_hidden, h // 2)
        self.text_map_k_layer = _k_layer(c.map_output_size, h // 2)
        self.second_state_compress = nn.Sequential(
            tdense(c.second_in_size, h), nn.ReLU())
        self._scale = 1.0 / math.sqrt(h // 2)

    def train(self, mode: bool = True) -> "MGMapNet":
        """Module mode, with the frozen UNet kept in eval mode."""
        super().train(mode)
        self.rgb_encoder.eval()
        return self

    # -- frame-level encoders ------------------------------------------------
    def encode_rgb(self, obs: dict[str, torch.Tensor]):
        """(rgb_in [B, 256], proj_feat NHWC or None, bottleneck NHWC). A
        cached ``rgb_features`` bottleneck bypasses the UNet."""
        if "rgb_features" in obs:
            bottleneck, proj_feat = obs["rgb_features"], None
        else:
            bottleneck, proj_feat, _ = self.rgb_encoder(obs["rgb"])
        rgb_in = self.rgb_linear(bottleneck.flatten(1, 2).transpose(1, 2))
        return rgb_in, proj_feat, bottleneck

    def encode_depth(self, obs: dict[str, torch.Tensor]):
        """(depth_in [B, 128], trunk NHWC). A cached ``depth_features``
        trunk output bypasses the ResNet50. The features are flattened
        channel-first, as torch does."""
        if "depth_features" in obs:
            feats, trunk = self.depth_encoder(cached=obs["depth_features"])
        else:
            feats, trunk = self.depth_encoder(depth=obs["depth"])
        return self.depth_linear(feats), trunk

    def encode_map(self, ego_map: torch.Tensor):
        """ego_map NHWC [B, E, E, C] -> (map_in [B, 256], map_embedding
        [B, S, 256] with S in row-major (h, w) order, pred_sem NHWC)."""
        x = ego_map.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        enc = self.map_encoder(x)                             # [B,256,24,24]
        enc_proj = self.map_encoded_linear(enc)               # [B,128,24,24]
        pred_sem = self.map_classfier(self.map_decoder(enc))  # [B,27,48,48]
        pred_sem = pred_sem.permute(0, 2, 3, 1)
        cls_proj = self.map_classified_linear(
            avg_pool2d_nhwc(pred_sem, 2, 2).permute(0, 3, 1, 2))
        emb = self.map_cated_linear(torch.cat([enc_proj, cls_proj], 1))
        map_embedding = emb.permute(0, 2, 3, 1).flatten(1, 2)
        map_in = self.map_linear(map_embedding.transpose(1, 2))
        return map_in, map_embedding, pred_sem

    def encode_frames(self, obs: dict[str, torch.Tensor],
                      global_map: torch.Tensor | None = None,
                      masks: torch.Tensor | None = None
                      ) -> tuple[FrameFeatures, torch.Tensor | None]:
        """All non-recurrent compute for a batch of frames.

        Bypasses: ``text_features`` + ``text_pad`` (the rollout engine's
        per-episode text cache) skip the biLSTM; ``rgb_features`` and
        ``depth_features`` skip the trunks; ``rgb_ego_map`` skips the
        mapping step. Without ``rgb_ego_map`` the mapping step runs and
        updates ``global_map`` in place (returned second; None when
        skipped). ``masks`` [B, 1] is 0 at an episode start.
        """
        c = self.cfg
        if "text_features" in obs:
            text, text_pad = obs["text_features"], obs["text_pad"]
        else:
            text, text_pad = self.instruction_encoder(obs["instruction"])
        rgb_in, proj_feat, rgb_bottleneck = self.encode_rgb(obs)
        new_global = None
        if "rgb_ego_map" in obs:
            ego_map = obs["rgb_ego_map"]
        else:
            if global_map is None or masks is None or proj_feat is None:
                raise ValueError("the mapping step needs rgb, global_map "
                                 "and masks")
            ego_map, new_global = rgb_mapping_step(
                global_map, proj_feat, obs["depth"], obs["gps"],
                obs["compass"], masks, c.mapper)
        depth_in, depth_trunk = self.encode_depth(obs)
        map_in, map_embedding, pred_sem = self.encode_map(ego_map)
        parts = [t for name, t in (("rgb", rgb_in), ("depth", depth_in),
                                   ("map", map_in)) if name in c.input_type]
        return (FrameFeatures(torch.cat(parts, 1), map_embedding, text,
                              text_pad, pred_sem, ego_map, rgb_bottleneck,
                              depth_trunk),
                new_global)

    # -- recurrent core --------------------------------------------------------
    def _core(self, f: FrameFeatures, h1: torch.Tensor, h2: torch.Tensor,
              mask: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One decision step: (features [B, H], GRU1 state, att_map [B, S]).
        Both GRUs see their hidden state times the episode mask."""
        mask = mask.reshape(-1, 1)
        state, _ = self.state_encoder(f.state_in, h1, mask)
        k1 = self.state_text_k_layer
        text_emb, _ = _attend(
            self.state_text_q_layer(state),
            F.linear(f.text, k1.weight[..., 0], k1.bias), f.text,
            self._scale, f.text_pad)
        k2 = self.text_map_k_layer
        map_att, att_map = _attend(
            self.text_map_q_layer(text_emb),
            F.linear(f.map_embedding, k2.weight[..., 0], k2.bias),
            f.map_embedding, self._scale)
        parts = [state, text_emb]
        if "map" in self.cfg.input_type:
            parts.append(map_att)
        x = self.second_state_compress(torch.cat(parts, 1))
        features, _ = self.second_state_encoder(x, h2, mask)
        return features, state, att_map

    def step(self, obs: dict[str, torch.Tensor], hidden: torch.Tensor,
             masks: torch.Tensor, global_map: torch.Tensor | None = None
             ) -> tuple[FrameFeatures, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor | None]:
        """One decision step; hidden [2, B, H]. Returns (frames, features,
        hidden', att_map, new_global)."""
        frames, new_global = self.encode_frames(obs, global_map, masks)
        features, h1, att_map = self._core(frames, hidden[0], hidden[1],
                                           masks)
        return (frames, features, torch.stack([h1, features]), att_map,
                new_global)

    def forward(self, obs: dict[str, torch.Tensor], hidden: torch.Tensor,
                masks: torch.Tensor, global_map: torch.Tensor | None = None):
        """``step`` as the JAX package's ``MGMapNet.__call__`` returns it:
        (features, hidden', pred_sem_map, att_map, ego_map, new_global)."""
        frames, features, hidden, att_map, new_global = self.step(
            obs, hidden, masks, global_map)
        return (features, hidden, frames.pred_sem_map, att_map,
                frames.ego_map, new_global)

    def seq(self, obs: dict[str, torch.Tensor], hidden0: torch.Tensor,
            masks: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Teacher forcing over an episode-major batch: obs leaves [N, T,
        ...], hidden0 [2, N, H], masks [N, T] (0 at an episode start). The
        encoders run once over the N*T frames, then the recurrent core
        steps over T. Returns (features [N, T, H], pred_sem [N, T, 2E', 2E',
        classes], att_map [N, T, S])."""
        n, t_steps = masks.shape[:2]
        frames, _ = self.encode_frames(
            {k: v.reshape(n * t_steps, *v.shape[2:]) for k, v in obs.items()})

        def split(x):
            return x.reshape(n, t_steps, *x.shape[1:])

        # per-step views by unbind: its backward is one stack, where
        # indexing [:, k] would write a full-size zero gradient per step
        steps = zip(*(split(x).unbind(1) for x in (
            frames.state_in, frames.map_embedding, frames.text,
            frames.text_pad)), masks.unbind(1))
        h1, h2 = hidden0[0], hidden0[1]
        feats, atts = [], []
        for state_in, map_emb, text, text_pad, mask in steps:
            f = FrameFeatures(state_in, map_emb, text, text_pad, None, None)
            h2, h1, att = self._core(f, h1, h2, mask)
            feats.append(h2)
            atts.append(att)
        return (torch.stack(feats, 1), split(frames.pred_sem_map),
                torch.stack(atts, 1))

    def update_map(self, obs: dict[str, torch.Tensor], masks: torch.Tensor,
                   global_map: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Map-only step between decisions: UNet proj_feat -> projection ->
        registration. The global map is updated in place and returned."""
        _, proj_feat, _ = self.rgb_encoder(obs["rgb"])
        return rgb_mapping_step(global_map, proj_feat, obs["depth"],
                                obs["gps"], obs["compass"], masks,
                                self.cfg.mapper)


class PolicyOutputs(NamedTuple):
    value: torch.Tensor
    action: torch.Tensor
    action_log_probs: torch.Tensor
    hidden: torch.Tensor
    prog: torch.Tensor
    pred_sem_map: torch.Tensor
    att_map: torch.Tensor
    ego_map: torch.Tensor
    global_map: torch.Tensor | None
    # the trunks' outputs, which DAgger collection caches
    rgb_features: torch.Tensor | None = None
    depth_features: torch.Tensor | None = None


class BasePolicy(nn.Module):
    """Actor-critic wrapper: the net, a 2-D Gaussian waypoint head, the
    critic and the progress head."""

    def __init__(self, cfg: MGMapConfig):
        super().__init__()
        self.cfg = cfg
        self.net = MGMapNet(cfg)
        self.action_distribution = DiagGaussian(cfg.hidden_size, 2)
        self.critic = CriticHead(cfg.hidden_size)
        self.prog_pred = tdense(cfg.hidden_size, 1)

    def act(self, obs: dict[str, torch.Tensor], hidden: torch.Tensor,
            masks: torch.Tensor, global_map: torch.Tensor | None = None
            ) -> PolicyOutputs:
        """One decision step; the action is the Gaussian's mode."""
        frames, features, hidden, att_map, new_global = self.net.step(
            obs, hidden, masks, global_map)
        dist = self.action_distribution(features)
        action = dist.mode()
        return PolicyOutputs(
            self.critic(features), action, dist.log_probs(action), hidden,
            torch.tanh(self.prog_pred(features)), frames.pred_sem_map,
            att_map, frames.ego_map, new_global, frames.rgb_features,
            frames.depth_features)

    def update_map(self, obs, masks, global_map):
        return self.net.update_map(obs, masks, global_map)

    def encode_text(self, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(text [B, L, 2H], text_pad [B, L]) on the policy's device, for
        the rollout engine's per-episode cache (``encode_frames``'
        ``text_features`` bypass). The engine passes the tokens on the
        host, where the biLSTM's step count is read without a sync."""
        return self.net.instruction_encoder(tokens)

    def forward_seq(self, obs: dict[str, torch.Tensor],
                    hidden0: torch.Tensor, masks: torch.Tensor
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Teacher forcing over [N, T, ...] batches (``MGMapNet.seq``):
        (the Gaussian's mean [N, T, 2], not tanh'd; {"features",
        "pred_sem_map", "att_map", "prog"})."""
        features, pred_sem, att_map = self.net.seq(obs, hidden0, masks)
        return self.action_distribution(features).mean, {
            "features": features,
            "pred_sem_map": pred_sem,
            "att_map": att_map,
            "prog": torch.tanh(self.prog_pred(features)),
        }
