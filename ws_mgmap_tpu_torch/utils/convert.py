"""JAX variables -> the port's ``state_dict``.

The port's own copy of the key and leaf rules of
``ws_mgmap_tpu/utils/convert.py`` (flax path ``a/b/0/kernel`` -> torch key
``a.b.0.weight``; conv kernel [kh, kw, I, O] -> [O, I, kh, kw]; dense
kernel [in, out] -> [out, in]; BN ``scale`` -> ``weight``,
``mean``/``var`` -> ``running_mean``/``running_var``; leaves named with a
dot, and RNN weights, are stored in torch layout already; the raw
[out, in] weights of the policy's two ``Conv1d(k=1)`` key layers get the
trailing unit dimension of torch's [out, in, 1]). It reads plain nested
dicts of numpy arrays, so it needs neither JAX nor flax.
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
