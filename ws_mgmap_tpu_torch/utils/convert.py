"""JAX variables -> the port's ``state_dict``.

The port's own copy of the key and leaf rules of
``ws_mgmap_tpu/utils/convert.py`` (flax path ``a/b/0/kernel`` -> torch key
``a.b.0.weight``; conv kernel [kh, kw, I, O] -> [O, I, kh, kw]; dense
kernel [in, out] -> [out, in]; BN ``scale`` -> ``weight``,
``mean``/``var`` -> ``running_mean``/``running_var``; leaves named with a
dot, and RNN weights, are stored in torch layout already; the raw
[out, in] weights of the policy's two ``Conv1d(k=1)`` key layers get the
trailing unit dimension of torch's [out, in, 1]). It reads plain nested
dicts of numpy arrays, so it needs neither JAX nor flax. The same rules
carry the DD-PPO controller's tree (``models/ddppo_policy.py``): its raw
``visual_fc.1.*``, ``tgt_embeding.*`` and ``state_encoder.rnn.*``
parameters, the ``nn.Embed`` table and ``critic.fc`` as a flax ``Dense``.

``load_torch_checkpoint`` reads a reference checkpoint file in any of its
three framings; ``load_matching``, ``import_imagenet_resnet18`` and
``ddppo_depth_state`` put pretrained torch weights into the policy by the
JAX package's key rules.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

LEAF_TO_TORCH = {
    "kernel": "weight",
    "kernel_t": "weight",
    "scale": "weight",
    "bias": "bias",
    "embedding": "weight",
    "mean": "running_mean",
    "var": "running_var",
}

_RNN_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")

# the torch-key prefixes of the modules this port has: all of BasePolicy
PORTED_PREFIXES = ("net.", "action_distribution.", "critic.", "prog_pred.")

# MGMapNet's torch Conv1d(k=1) weights, which the JAX package keeps [out, in]
CONV1D_WEIGHTS = ("state_text_k_layer.weight", "text_map_k_layer.weight")


def _is_raw_torch_leaf(leaf: str) -> bool:
    return ("." in leaf or leaf == "_bias"
            or any(leaf.startswith(p) for p in _RNN_LEAVES))


def _torch_key(path: tuple[str, ...]) -> str:
    *mods, leaf = path
    mapped = leaf if _is_raw_torch_leaf(leaf) else LEAF_TO_TORCH.get(leaf,
                                                                      leaf)
    return ".".join(list(mods) + [mapped])


def _to_torch_leaf(a: np.ndarray, leaf: str, key: str) -> np.ndarray:
    if _is_raw_torch_leaf(leaf) or leaf in ("scale", "bias", "mean", "var",
                                            "embedding"):
        if key.endswith(CONV1D_WEIGHTS):
            return a[..., None]  # raw dense [out, in] -> Conv1d [out, in, 1]
        return a
    if leaf == "kernel":
        if a.ndim == 4:  # conv [kh, kw, I, O] -> [O, I, kh, kw]
            return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))
        return np.ascontiguousarray(a.T)  # dense [in, out] -> [out, in]
    if leaf == "kernel_t":  # transposed conv, with its spatial flip
        return np.ascontiguousarray(np.transpose(a[::-1, ::-1], (2, 3, 0, 1)))
    return a


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(tree: Mapping[str, Any],
                       prefixes: tuple[str, ...] = PORTED_PREFIXES
                       ) -> dict[str, torch.Tensor]:
    """JAX variables ``{"params": …, "batch_stats": …}`` as nested dicts of
    numpy arrays -> the port's state_dict: the keys under ``prefixes``,
    plus a zero ``num_batches_tracked`` beside each BatchNorm's statistics
    (a buffer torch keeps and the JAX package has no counterpart of), so
    ``load_state_dict(strict=True)`` fills every parameter and buffer."""
    out: dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(tree.get(coll, {})):
            key = _torch_key(path)
            if not key.startswith(prefixes):
                continue
            arr = _to_torch_leaf(np.asarray(leaf), path[-1], key)
            out[key] = torch.from_numpy(np.array(arr))
            if key.endswith(".running_mean"):
                nbt = key[: -len("running_mean")] + "num_batches_tracked"
                out[nbt] = torch.zeros((), dtype=torch.int64)
    return out


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A torch .pth/.pt on the CPU as a flat state_dict. The three
    reference framings:
      * a raw state_dict,
      * {"state_dict": ...} (policy ckpts, `common_trainer.py:98-104`),
      * {"models": {"img_segm_model": ...}} (UNet ckpt,
        `unet_encoder.py:19-21`), its keys' first two parts dropped.
    The reference's checkpoints pickle their config beside the weights,
    so this unpickles in full: load only files you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "models" in blob:
        sd = blob["models"]["img_segm_model"]
        sd = {".".join(k.split(".")[2:]): v for k, v in sd.items()}
    elif isinstance(blob, dict) and "state_dict" in blob:
        sd = blob["state_dict"]
    else:
        sd = blob
    return {k: v.detach().cpu() for k, v in sd.items()}


def load_matching(module: torch.nn.Module,
                  state_dict: Mapping[str, Any]) -> list[str]:
    """Loads the entries of ``state_dict`` whose keys ``module`` has (the
    JAX package's ``import_torch_state``: the rest of the module keeps its
    values); raises ValueError where a shape differs. Returns the keys it
    did not use, ``num_batches_tracked`` left out, as JAX counts them."""
    own = module.state_dict()
    hit = {}
    for k, v in state_dict.items():
        if k not in own:
            continue
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"cannot map torch {tuple(v.shape)} to "
                             f"{tuple(own[k].shape)} for {k!r}")
        hit[k] = v.to(own[k].dtype)
    module.load_state_dict(hit, strict=False)
    return [k for k in state_dict
            if k not in hit and "num_batches_tracked" not in k]


def import_imagenet_resnet18(policy: torch.nn.Module,
                             sd: Mapping[str, Any]) -> int:
    """Seed the UNet and MapDecoder backbones of ``policy`` from a
    torchvision resnet18 ImageNet state_dict (from-scratch stage-1 init,
    reference `unet_encoder.py:34` / `map_encoder.py:75`
    `pretrained=True`), in place.

    Key remapping (torchvision -> the policy's module paths):
      conv1/bn1      -> layer0.0 / layer0.1
      layer1.*       -> layer1.1.*   (maxpool+layer1 live under one module)
      layer2..layer4 -> unchanged    (UNet only; MapDecoder has no 2..4)
    The MapDecoder's conv1 is the reference's (256-channel input,
    `map_encoder.py:76`), so only bn1 + layer1 transfer there.
    Returns the number of tensors loaded, counted as the JAX package
    counts them."""
    def remap(key: str) -> str | None:
        if key.startswith("conv1."):
            return "layer0.0." + key[len("conv1."):]
        if key.startswith("bn1."):
            return "layer0.1." + key[len("bn1."):]
        if key.startswith("layer1."):
            return "layer1.1." + key[len("layer1."):]
        if key.startswith(("layer2.", "layer3.", "layer4.")):
            return key
        return None  # fc.*: unused

    unet_sd, dec_sd = {}, {}
    for k, v in sd.items():
        m = remap(k)
        if m is None:
            continue
        unet_sd[f"net.rgb_encoder.base_model.{m}"] = v
        if m.startswith(("layer0.1.", "layer1.1.")):
            dec_sd[f"net.map_decoder.{m}"] = v
    unused_u = load_matching(policy, unet_sd)
    unused_d = load_matching(policy, dec_sd)
    return (len(unet_sd) - len(unused_u)) + (len(dec_sd) - len(unused_d))


def ddppo_depth_state(raw: Mapping[str, Any]) -> dict[str, Any]:
    """The depth encoder's entries of a DD-PPO checkpoint's state_dict
    (``actor_critic.net.visual_encoder.*``, `resnet_encoders.py:37-50`)
    under the policy's keys (``net.depth_encoder.visual_encoder.*``)."""
    out = {}
    for k, v in raw.items():
        parts = k.split(".")[2:]
        if parts and parts[0] == "visual_encoder":
            out["net.depth_encoder." + ".".join(parts)] = v
    return out
