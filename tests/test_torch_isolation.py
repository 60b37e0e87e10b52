"""The port stands alone: no JAX, flax or ws_mgmap_tpu import anywhere in
``ws_mgmap_tpu_torch/`` or ``chip_smoke.py``, nor OpenCV, PyYAML or psutil,
which the port does without (its own YAML reader and line raster); and
its entry points run on the card unless the caller asks for the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.ops.mapping import MapperParams, init_global_map
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ws_mgmap_tpu", "cv2", "yaml", "psutil")


def _port_files():
    files = sorted((ROOT / "ws_mgmap_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.is_file() for f in files)
    bad = {(f.name, m) for f in files for m in _imported_roots(f)
           if m in FORBIDDEN}
    assert not bad, bad


def test_entry_points_default_to_the_card():
    p = MapperParams(ego_size=10, global_size=24, map_depth=8)
    policy = BasePolicy(MGMapConfig(unet_width=0.125, map_depth=8, mapper=p))
    if torch.cuda.is_available():
        assert init_global_map(1, p).device.type == "cuda"
        assert RolloutEngine(policy, 1).global_map.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_global_map(1, p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RolloutEngine(policy, 1)
    eng = RolloutEngine(policy, 1, device="cpu")
    assert eng.global_map.device.type == "cpu"
    assert next(eng.policy.parameters()).device.type == "cpu"


def test_keep_drops_env_slots():
    p = MapperParams(ego_size=10, global_size=24, map_depth=8)
    policy = BasePolicy(MGMapConfig(unet_width=0.125, map_depth=8, mapper=p))
    eng = RolloutEngine(policy, 3, device="cpu")
    eng.global_map += torch.arange(3.0)[:, None, None, None]
    eng.keep([0, 2])
    assert eng.num_envs == 2
    np.testing.assert_array_equal(eng.global_map[:, 0, 0, 0].numpy(),
                                  [0.0, 2.0])
