"""The WS-MGMap CMA policy in plain PyTorch, written as functions of a
state dict (the reference's torch keys): the frozen ResNet18-UNet, the
GroupNorm ResNet50 depth trunk, the map encoder, decoder and classifier,
the instruction biLSTM, the GRU-attention-GRU core and the heads.

Everything runs unfused, NCHW, BatchNorm from its statistics as stored
(eval) or from the batch (train, the normalisation torch's train mode
computes), in the arithmetic of :mod:`precision`. Observations, the ego
map and the semantic logits are NHWC at the boundary, as the system under
test keeps them. ``cfg`` is the configuration's dict of sizes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import mapping
from benchmark.reference.precision import (conv2d, conv_transpose2d, linear,
                                           matmul, q)

EPS = 1e-5


def widths(cfg) -> tuple[int, int, int, int]:
    w = cfg["unet_width"]
    return tuple(max(8, int(c * w)) for c in (64, 128, 256, 512))


# -- building blocks ---------------------------------------------------------
def bn(sd, p: str, x, train: bool = False):
    if train:
        return F.batch_norm(x, None, None, sd[p + ".weight"], sd[p + ".bias"],
                            True, 0.0, EPS)
    return F.batch_norm(x, sd[p + ".running_mean"], sd[p + ".running_var"],
                        sd[p + ".weight"], sd[p + ".bias"], False, 0.0, EPS)


def gn(sd, p: str, x, groups: int):
    return F.group_norm(x, groups, sd[p + ".weight"], sd[p + ".bias"], EPS)


def conv(sd, p: str, x, stride=1, padding=0):
    return conv2d(x, sd[p + ".weight"], sd.get(p + ".bias"), stride, padding)


def conv_bn_relu(sd, p: str, x, padding: int, train: bool = False):
    """The reference's ``convrelu``: Conv2d "0", BatchNorm2d "1", ReLU."""
    return F.relu(bn(sd, p + ".1", conv(sd, p + ".0", x, 1, padding), train))


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def max_pool(x):
    return F.max_pool2d(x, 3, 2, 1)


def basic_block(sd, p: str, x, stride: int, train: bool = False):
    identity = x
    if p + ".downsample.0.weight" in sd:
        identity = bn(sd, p + ".downsample.1",
                      conv(sd, p + ".downsample.0", x, stride), train)
    out = F.relu(bn(sd, p + ".bn1", conv(sd, p + ".conv1", x, stride, 1),
                    train))
    out = bn(sd, p + ".bn2", conv(sd, p + ".conv2", out, 1, 1), train)
    return F.relu(out + identity)


def res_layer(sd, p: str, x, stride: int, train: bool = False):
    return basic_block(sd, p + ".1", basic_block(sd, p + ".0", x, stride,
                                                 train), 1, train)


def stem(sd, p: str, x, train: bool = False):
    """``layer0``: 7x7 stride-2 conv, BN, ReLU."""
    return F.relu(bn(sd, p + ".1", conv(sd, p + ".0", x, 2, 3), train))


# -- the frozen UNet -----------------------------------------------------------
def unet(sd, rgb):
    """rgb NHWC [B, H, W, 3] -> (bottleneck NHWC [B, H/32, W/32, 512],
    proj_feat NHWC [B, H, W, 64])."""
    p = "net.rgb_encoder.base_model."
    x = rgb.permute(0, 3, 1, 2)
    x_orig = conv_bn_relu(sd, p + "conv_original_size0", x, 1)
    x_orig = conv_bn_relu(sd, p + "conv_original_size1", x_orig, 1)
    layer0 = stem(sd, p + "layer0", x)
    layer1 = res_layer(sd, p + "layer1.1", max_pool(layer0), 1)
    layer2 = res_layer(sd, p + "layer2", layer1, 2)
    layer3 = res_layer(sd, p + "layer3", layer2, 2)
    layer4 = res_layer(sd, p + "layer4", layer3, 2)
    layer4 = conv_bn_relu(sd, p + "layer4_1x1", layer4, 0)
    y = up2(layer4)
    y = conv_bn_relu(sd, p + "conv_up3", torch.cat(
        [y, conv_bn_relu(sd, p + "layer3_1x1", layer3, 0)], 1), 1)
    y = up2(y)
    y = conv_bn_relu(sd, p + "conv_up2", torch.cat(
        [y, conv_bn_relu(sd, p + "layer2_1x1", layer2, 0)], 1), 1)
    y = up2(y)
    y = conv_bn_relu(sd, p + "conv_up1", torch.cat(
        [y, conv_bn_relu(sd, p + "layer1_1x1", layer1, 0)], 1), 1)
    y = up2(y)
    y = conv_bn_relu(sd, p + "conv_up0", torch.cat(
        [y, conv_bn_relu(sd, p + "layer0_1x1", layer0, 0)], 1), 1)
    y = up2(y)
    proj = conv_bn_relu(sd, p + "conv_original_size2",
                        torch.cat([y, x_orig], 1), 1)
    return layer4.permute(0, 2, 3, 1), proj.permute(0, 2, 3, 1)


# -- the depth trunk -----------------------------------------------------------
def gn_bottleneck(sd, p: str, x, stride: int, groups: int = 16):
    identity = x
    if p + ".downsample.0.weight" in sd:
        identity = gn(sd, p + ".downsample.1",
                      conv(sd, p + ".downsample.0", x, stride), groups)
    y = F.relu(gn(sd, p + ".convs.1", conv(sd, p + ".convs.0", x), groups))
    y = F.relu(gn(sd, p + ".convs.4", conv(sd, p + ".convs.3", y, stride, 1),
                  groups))
    y = gn(sd, p + ".convs.7", conv(sd, p + ".convs.6", y), groups)
    return F.relu(y + identity)


def depth_trunk(sd, depth):
    """depth NHWC [B, H, W, 1] (habitat's [0, 1]) -> NHWC [B, H/64, W/64,
    128]: habitat's DD-PPO ResNetEncoder (GroupNorm ResNet50, base planes
    32, layers 3-4-6-3) after a 2x average pool, then the 3x3
    compression."""
    p = "net.depth_encoder.visual_encoder."
    x = F.avg_pool2d(depth.permute(0, 3, 1, 2), 2)
    b = p + "backbone."
    x = max_pool(F.relu(gn(sd, b + "bn1", conv(sd, b + "conv1", x, 2, 3), 16)))
    for li, (blocks, stride) in enumerate(((3, 1), (4, 2), (6, 2), (3, 2)),
                                          start=1):
        for k in range(blocks):
            x = gn_bottleneck(sd, f"{b}layer{li}.{k}", x,
                              stride if k == 0 else 1)
    x = F.relu(gn(sd, p + "compression.1",
                  conv(sd, p + "compression.0", x, 1, 1), 1))
    return x.permute(0, 2, 3, 1)


def depth_in(sd, trunk):
    """trunk NHWC [B, h, w, 128] -> [B, depth_output_size]: the spatial
    embeddings (the [h*w, 64] table read as [64, h, w]) appended on
    channels, flattened channel-first, Linear, ReLU."""
    x = trunk.permute(0, 3, 1, 2)
    b, _, h, w = x.shape
    spatial = sd["net.depth_encoder.spatial_embeddings.weight"].reshape(
        -1, h, w)
    x = torch.cat([x, spatial[None].expand(b, -1, h, w)], 1)
    return F.relu(linear(x.flatten(1), sd["net.depth_linear.1.weight"],
                         sd["net.depth_linear.1.bias"]))


def rgb_in(sd, bottleneck):
    x = bottleneck.flatten(1, 2).mean(1)
    return F.relu(linear(x, sd["net.rgb_linear.2.weight"],
                         sd["net.rgb_linear.2.bias"]))


# -- the instruction encoder -------------------------------------------------------
def lstm_step(x, h, c, w_ih, w_hh, b_ih, b_hh):
    g = linear(x, w_ih, b_ih) + linear(h, w_hh, b_hh)
    i, f, gg, o = g.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def encode_text(sd, tokens):
    """tokens [B, L] int (0 = pad) -> (features [B, L, 2H], pad [B, L]):
    word embeddings into a one-layer biLSTM over each row's real prefix
    (zeros past it), as ``pack_padded_sequence`` runs it."""
    p = "net.instruction_encoder."
    dev = sd[p + "embedding_layer.weight"].device
    tokens = tokens.to(dev).long()
    bsz, length = tokens.shape
    lengths = (tokens != 0).sum(1)
    emb = F.embedding(tokens, sd[p + "embedding_layer.weight"])
    r = p + "encoder_rnn."
    hid = sd[r + "weight_hh_l0"].shape[1]
    steps = max(int(lengths.max()), 1)
    ks = torch.arange(steps, device=dev)
    live = ks[None, :] < lengths[:, None]                    # [B, steps]
    rows = torch.arange(bsz, device=dev)
    parts = []
    for sfx in ("", "_reverse"):
        w = [sd[r + k + sfx] for k in ("weight_ih_l0", "weight_hh_l0",
                                       "bias_ih_l0", "bias_hh_l0")]
        h = emb.new_zeros(bsz, hid)
        c = emb.new_zeros(bsz, hid)
        ys = []
        for k in range(steps):
            # the forward direction reads position k, the backward one
            # position len - 1 - k; a row past its length keeps its state
            pos = (torch.full_like(lengths, k) if not sfx
                   else (lengths - 1 - k).clamp(min=0))
            h_new, c_new = lstm_step(emb[rows, pos], h, c, *w)
            keep = live[:, k:k + 1]
            h = torch.where(keep, h_new, h)
            c = torch.where(keep, c_new, c)
            ys.append(h_new)
        ys = torch.stack(ys, 1)                              # [B, steps, H]
        if sfx:  # step k of the backward run belongs to position len-1-k
            idx = (lengths[:, None] - 1 - ks[None, :]).clamp(0, steps - 1)
            ys = ys.gather(1, idx[..., None].expand(-1, -1, hid))
        parts.append(ys)
    out = torch.where(live[..., None], torch.cat(parts, -1), 0.0)
    out = F.pad(out, (0, 0, 0, length - steps))
    pad = torch.arange(length, device=dev)[None, :] >= lengths[:, None]
    return out, pad


# -- the map modules -------------------------------------------------------------
def map_encoder(sd, x, train=False):
    p = "net.map_encoder.cnn."
    x = F.relu(bn(sd, p + "1", conv(sd, p + "0", x, 2, 3), train))
    x = F.relu(bn(sd, p + "4", conv(sd, p + "3", x, 2, 1), train))
    return F.relu(bn(sd, p + "7", conv(sd, p + "6", x, 1, 1), train))


def map_decoder(sd, x, train=False):
    p = "net.map_decoder."
    x_orig = conv_bn_relu(sd, p + "conv_original_size0", x, 1, train)
    x_orig = conv_bn_relu(sd, p + "conv_original_size1", x_orig, 1, train)
    layer0 = stem(sd, p + "layer0", x, train)
    layer1 = res_layer(sd, p + "layer1.1", max_pool(layer0), 1, train)
    layer1 = conv_bn_relu(sd, p + "layer1_1x1", layer1, 0, train)
    y = up2(layer1)
    y = conv_bn_relu(sd, p + "conv_up0", torch.cat(
        [y, conv_bn_relu(sd, p + "layer0_1x1", layer0, 0, train)], 1), 1,
        train)
    y = up2(y)
    return conv_bn_relu(sd, p + "conv_original_size2",
                        torch.cat([y, x_orig], 1), 1, train)


def map_classifier(sd, x, train=False):
    p = "net.map_classfier."
    x = conv_transpose2d(x, sd[p + "0.weight"], None, 2, 1)
    x = F.relu(bn(sd, p + "1", x, train))
    x = F.relu(bn(sd, p + "4", conv(sd, p + "3", x, 1, 1), train))
    return conv(sd, p + "6", x)


def encode_map(sd, ego_map, train=False):
    """ego NHWC [B, E, E, C] -> (map_in [B, 256], map_embedding [B, S,
    256] rows in (h, w) order, pred_sem NHWC [B, 2s, 2s, classes])."""
    x = q(ego_map).permute(0, 3, 1, 2)
    enc = map_encoder(sd, x, train)
    n = "net."
    enc_proj = F.relu(conv(sd, n + "map_encoded_linear.0", enc, 1, 1))
    pred_sem = map_classifier(sd, map_decoder(sd, enc, train), train)
    cls_proj = F.relu(conv(sd, n + "map_classified_linear.0",
                           F.avg_pool2d(pred_sem, 2, 2), 1, 1))
    emb = F.relu(conv(sd, n + "map_cated_linear.0",
                      torch.cat([enc_proj, cls_proj], 1), 1, 1))
    emb = emb.permute(0, 2, 3, 1).flatten(1, 2)
    map_in = F.relu(linear(emb.mean(1), sd[n + "map_linear.2.weight"],
                           sd[n + "map_linear.2.bias"]))
    return map_in, emb, pred_sem.permute(0, 2, 3, 1)


# -- the recurrent core and the heads ---------------------------------------------
def gru(sd, p: str, x, h, mask):
    """habitat's RNNStateEncoder step: a GRU cell on h * mask."""
    h = h * mask
    gi = linear(x, sd[p + "weight_ih_l0"], sd[p + "bias_ih_l0"])
    gh = linear(h, sd[p + "weight_hh_l0"], sd[p + "bias_hh_l0"])
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def attend(query, keys, values, scale, pad=None):
    logits = matmul(keys, query[:, :, None])[..., 0]
    if pad is not None:
        logits = logits - pad.to(logits.dtype) * 1e8
    att = torch.softmax(logits * scale, dim=1)
    return matmul(att[:, None, :], values)[:, 0], att


def dense(sd, p: str, x):
    return linear(x, sd[p + ".weight"], sd[p + ".bias"])


def core(sd, cfg, state_in, map_emb, text, text_pad, h1, h2, mask):
    """One step of GRU1 -> text attention -> map attention -> GRU2:
    (features, GRU1 state, att_map)."""
    n = "net."
    mask = mask.reshape(-1, 1)
    scale = 1.0 / math.sqrt(cfg["hidden_size"] // 2)
    state = gru(sd, n + "state_encoder.rnn.", state_in, h1, mask)
    k1 = linear(text, sd[n + "state_text_k_layer.weight"][..., 0],
                sd[n + "state_text_k_layer.bias"])
    text_emb, _ = attend(dense(sd, n + "state_text_q_layer", state), k1, text,
                         scale, text_pad)
    k2 = linear(map_emb, sd[n + "text_map_k_layer.weight"][..., 0],
                sd[n + "text_map_k_layer.bias"])
    map_att, att_map = attend(dense(sd, n + "text_map_q_layer", text_emb), k2,
                              map_emb, scale)
    x = F.relu(dense(sd, n + "second_state_compress.0",
                     torch.cat([state, text_emb, map_att], 1)))
    features = gru(sd, n + "second_state_encoder.rnn.", x, h2, mask)
    return features, state, att_map


def heads(sd, features):
    """(the waypoint, the Gaussian's mean; the tanh progress)."""
    mean = dense(sd, "action_distribution.fc_mean", features)
    return mean, torch.tanh(dense(sd, "prog_pred", features))


# -- the rollout steps -------------------------------------------------------------
def update_map(sd, cfg, obs, masks, global_map):
    """The map-only step: (ego_map, new global map)."""
    _, proj = unet(sd, q(obs["rgb"]))
    return mapping.mapping_step(cfg, global_map, proj, q(obs["depth"]),
                                obs["gps"], obs["compass"], masks)


def act(sd, cfg, obs, hidden, masks, global_map):
    """One decision step from the state given: a dict of the outputs the
    rollout hands on (``action``, ``prog``, ``hidden``, ``global_map``,
    ``ego_map``, ``rgb_features``, ``depth_features``,
    ``pred_sem_map``)."""
    text, text_pad = encode_text(sd, obs["instruction"])
    bottleneck, proj = unet(sd, q(obs["rgb"]))
    ego, new_global = mapping.mapping_step(cfg, global_map, proj,
                                           q(obs["depth"]), obs["gps"],
                                           obs["compass"], masks)
    trunk = depth_trunk(sd, q(obs["depth"]))
    map_in, map_emb, pred_sem = encode_map(sd, ego)
    state_in = torch.cat([rgb_in(sd, bottleneck), depth_in(sd, trunk),
                          map_in], 1)
    hidden = q(hidden)
    features, h1, _ = core(sd, cfg, state_in, map_emb, text, text_pad,
                           hidden[0], hidden[1], masks)
    action, prog = heads(sd, features)
    return {"action": action, "prog": prog,
            "hidden": torch.stack([h1, features]), "global_map": new_global,
            "ego_map": ego, "rgb_features": bottleneck,
            "depth_features": trunk, "pred_sem_map": pred_sem}
