"""Model operations of a whole step, counted from shapes: the reference
policy run on meta tensors under ``FlopCounterMode``, which counts the
multiply-adds (x2) of every convolution and matrix product and nothing
else. These are the operations that ``mfu`` divides by the window."""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import policy as P


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def bilstm_flops_per_token(cfg: dict) -> float:
    """Both directions' gate products for one token of one row."""
    h, i = cfg["instr_hidden"], cfg["embedding_size"]
    return 2 * (2.0 * i * 4 * h + 2.0 * h * 4 * h)


@functools.lru_cache(maxsize=None)
def _per_frame(cfg_items: tuple, shapes_items: tuple) -> dict:
    cfg = dict(cfg_items)
    sd = {k: _meta(s) for k, s in shapes_items}
    e, c, r, dh = (cfg["ego_map_size"], cfg["map_depth"], cfg["rgb_hw"],
                   cfg["depth_hw"])
    length, hid = cfg["instruction_len"], cfg["hidden_size"]
    s = cfg["depth_spatial"]
    rgb_c = max(8, int(512 * cfg["unet_width"]))
    unet = _count(lambda: P.unet(sd, _meta((1, r, r, 3))))
    trunk = _count(lambda: P.depth_trunk(sd, _meta((1, dh, dh, 1))))

    def frame_heads():
        map_in, emb, _ = P.encode_map(sd, _meta((1, e, e, c)))
        state_in = torch.cat([
            P.rgb_in(sd, _meta((1, r // 32, r // 32, rgb_c))),
            P.depth_in(sd, _meta((1, s, s, 128))), map_in], 1)
        text = _meta((1, length, 2 * cfg["instr_hidden"]))
        pad = _meta((1, length), torch.bool)
        h = _meta((1, hid))
        feats, _, _ = P.core(sd, cfg, state_in, emb, text, pad, h, h,
                             _meta((1, 1)))
        P.heads(sd, feats)

    rest = _count(frame_heads)
    return {"unet": unet, "depth_trunk": trunk, "rest": rest}


def per_frame(cfg: dict, shapes: dict) -> dict:
    """Operations of one frame: the UNet, the depth trunk, and the rest of
    a decision (map modules, linears, the core, the heads)."""
    return _per_frame(_freeze(cfg), _freeze(shapes))


def _freeze(d: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, (list, torch.Size))
                         else v) for k, v in d.items()
                        if not isinstance(v, dict)))


def update_map_flops(cfg: dict, shapes: dict, b: int) -> float:
    return b * per_frame(cfg, shapes)["unet"]


def act_flops(cfg: dict, shapes: dict, b: int) -> float:
    f = per_frame(cfg, shapes)
    return b * (f["unet"] + f["depth_trunk"] + f["rest"])


def encode_flops(cfg: dict, b: int, steps: int) -> float:
    """The biLSTM over ``b`` rows for ``steps`` steps (the batch's longest
    instruction)."""
    return b * steps * bilstm_flops_per_token(cfg)


def train_flops(cfg: dict, shapes: dict, words: int) -> float:
    """Forward and backward (3x the forward) of one valid replay frame
    whose instruction has ``words`` tokens: the map modules, linears,
    core and heads from the cached trunk features, and the biLSTM."""
    f = per_frame(cfg, shapes)
    return 3.0 * (f["rest"] + words * bilstm_flops_per_token(cfg))
