"""The port's config tree and its YAML reader against the JAX package's.

The port reads YAML with its own reader (``utils/config.py::loads``), not
PyYAML: it must give ``yaml.safe_load``'s result on every YAML of both
packages and on the scalars a command line passes. The port's
``get_config`` on its own YAMLs must give JAX's tree on JAX's YAMLs,
apart from ``BASE_TASK_CONFIG_PATH`` (each names its own package's task
YAML), before and after ``refine_config`` and with trailing opts. Runs
from the repo root: ``BASE_TASK_CONFIG_PATH`` is relative to it, and a
path that does not exist silently gives the default task config.
"""
import math
import pickle
from pathlib import Path

import pytest
import yaml

from ws_mgmap_tpu.config import default as jdefault
from ws_mgmap_tpu_torch.config import default
from ws_mgmap_tpu_torch.utils.config import Config, YAMLSubsetError, loads

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted(p.name for p in (ROOT / "ws_mgmap_tpu/config").glob("*.yaml"))
CONFIGS = [None, "CMA_AUG.yaml", "CMA_AUG_DA_TUNE.yaml", "FAKESIM_DEBUG.yaml"]
OPTS = ["NUM_PROCESSES", "3", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS",
        "80", "DAGGER.LR", "2.5e-4", "DAGGER.P", "0.5", "VIDEO_OPTION",
        "['disk', 'tensorboard']", "MODEL.ROLLOUT_BF16", "True",
        "EVAL.SPLIT", "val_unseen", "DAGGER.CKPT_TO_LOAD", "123",
        "use_ddppo", "yes", "NEW.KEY", "-16"]
SCALARS = ["1", "-1", "+7", "0", "1.5", "0.", "-3.", "2.5e-4", "3.0e+3",
           "+1.0E-2", ".5", ".inf", "-.Inf", "+.INF", "-.nan", "yes", "No",
           "on", "OFF", "true", "tRue", "null", "~", "", "abc", "a b", "-a",
           "_x", "<x", "data/{split}.json.gz", "a:b", "a#b",
           "x # comment", "True # a comment", "'quoted'", "'it''s'",
           "'a # b'", '"dq # x"', "[1, 'a', b c]", "[]", "[ ]", "[a b, c]",
           "[1,2 ,3]", "['disk']", "a: 1", "a: [1, 2]  # c"]
# PyYAML reads these (or refuses some); the subset refuses them all
OUTSIDE = ["0x1F", "017", "0b101", "08", "1_000", "190:20:30", "1:30.5",
           "5.0e12", "1e-5", "._5", "-.5", "1st", "2002-12-14", "<<", "=",
           "-", "[1, [2, 3]]", "{a: 1}", "[1, 2", "[1,]", "a: b: c",
           '"dq\\n"', "'x'y", "a:\n  - 1\n  - 2\n", "a: &x 1\n",
           "a: !!str 1\n", "a: |\n  text\n", "a: b\n c\n", "---\na: 1\n",
           "a: 'open\n", "a: 1\n  b: 2\n", "a:\n    b: 1\n  c: 2\n",
           "on: 1\n", "3d: x\n", "\ta: 1\n"]


@pytest.fixture(autouse=True)
def at_repo_root(monkeypatch):
    monkeypatch.chdir(ROOT)


@pytest.mark.parametrize("package", ["ws_mgmap_tpu", "ws_mgmap_tpu_torch"])
@pytest.mark.parametrize("name", YAMLS)
def test_reader_equals_safe_load_on_every_yaml(package, name):
    text = (ROOT / package / "config" / name).read_text()
    assert loads(text) == yaml.safe_load(text)


def test_reader_equals_safe_load_on_scalars():
    for s in SCALARS:
        got, want = loads(s), yaml.safe_load(s)
        assert type(got) is type(want) and got == want, (s, got, want)
    assert math.isnan(loads(".nan")) and math.isnan(loads(".NaN"))


def test_reader_raises_outside_its_subset():
    for text in OUTSIDE:
        with pytest.raises(YAMLSubsetError):
            loads(text)
    # so does a command-line value outside it
    cfg = Config({"A": 1})
    for value in ("0x10", "1e-4", "[1, 2"):
        with pytest.raises(YAMLSubsetError):
            cfg.merge_from_list(["A", value])
    assert cfg.A == 1


def _port_path(jax_tree: dict) -> dict:
    out = dict(jax_tree)
    out["BASE_TASK_CONFIG_PATH"] = out["BASE_TASK_CONFIG_PATH"].replace(
        "ws_mgmap_tpu/config/", "ws_mgmap_tpu_torch/config/")
    return out


@pytest.mark.parametrize("opts", [None, OPTS], ids=["no_opts", "opts"])
@pytest.mark.parametrize("name", CONFIGS)
def test_trees_equal_jax(name, opts):
    jpath = name and f"ws_mgmap_tpu/config/{name}"
    path = name and f"ws_mgmap_tpu_torch/config/{name}"
    jcfg = jdefault.get_config(jpath, list(opts) if opts else None)
    cfg = default.get_config(path, list(opts) if opts else None)
    if name in ("CMA_AUG.yaml", "CMA_AUG_DA_TUNE.yaml"):
        # the task YAML was found: not the silent fallback to defaults
        assert Path(cfg.BASE_TASK_CONFIG_PATH).is_file()
        assert cfg.BASE_TASK_CONFIG_PATH.startswith("ws_mgmap_tpu_torch/")
    assert cfg.to_dict() == _port_path(jcfg.to_dict())
    jref = jdefault.refine_config(jcfg, 1)
    ref = default.refine_config(cfg, 1)
    assert ref.is_frozen() and jref.is_frozen()
    assert ref.to_dict() == _port_path(jref.to_dict())


def test_task_yaml_is_read():
    """The aug task YAML sets SPLIT train_aug, the default is train: the
    port's CMA_AUG must reach its own task YAML."""
    cfg = default.get_config("ws_mgmap_tpu_torch/config/CMA_AUG.yaml")
    assert cfg.TASK_CONFIG.DATASET.SPLIT == "train_aug"
    ref = default.refine_config(cfg)
    assert ref.TASK_CONFIG.TASK.GT_SEMANTIC_MAP_SENSOR.SPLIT == "train_aug"
    assert ref.TASK_CONFIG.TASK.NDTW.SPLIT == "train_aug"


@pytest.mark.parametrize("name", CONFIGS)
def test_config_pickles(name):
    """Env workers get the config pickled: it comes back whole, as a
    ``Config``, unfrozen."""
    cfg = default.refine_config(default.get_config(
        name and f"ws_mgmap_tpu_torch/config/{name}", list(OPTS)))
    again = pickle.loads(pickle.dumps(cfg))
    assert isinstance(again, Config) and again.to_dict() == cfg.to_dict()
    assert isinstance(again.TASK_CONFIG, Config) and not again.is_frozen()
    assert again.TASK_CONFIG.SIMULATOR.TYPE == "FakeSim"
