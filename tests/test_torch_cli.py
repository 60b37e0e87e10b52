"""The port's command line (``python -m ws_mgmap_tpu_torch.run``) against
``run.py``'s.

Held:
  * for the same arguments each builds the same config, key by key (each
    package's own YAML; only the keys that name a package path differ);
  * with ``WS_MGMAP_PLATFORM=cpu``, ``--run-type train``, then ``eval`` of
    the checkpoint folder, then ``inference`` run to their end at the
    small end-to-end configuration (``tools/synthetic.py::TINY_OPTS``,
    episodes of at most 30 steps, envs in process), each leaving its
    run directory as ``run.py`` does;
  * without that variable and without a card the command raises, and an
    unknown platform is refused.
"""
import json
import os
import zipfile
from pathlib import Path

import pytest
import torch

import run as jax_run
from ws_mgmap_tpu.utils import bookkeeping as jbookkeeping
from ws_mgmap_tpu_torch import run as port_run
from ws_mgmap_tpu_torch.tools.synthetic import TINY_OPTS
from ws_mgmap_tpu_torch.train import trainer as trainer_mod
from ws_mgmap_tpu_torch.utils import bookkeeping

ROOT = Path(__file__).resolve().parents[1]
# the keys whose values name a path inside one package
PACKAGE_PATH_KEYS = {"BASE_TASK_CONFIG_PATH"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch work on one CPU thread: the policy is small,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


class Captured:
    """A trainer that records the config it was built with and runs
    nothing."""
    configs: list = []

    def __init__(self, config, **kwargs):
        Captured.configs.append(config)

    def train(self):
        pass

    eval = inference = train


@pytest.mark.parametrize("yaml", ["CMA_AUG.yaml", "CMA_AUG_DA_TUNE.yaml",
                                  "FAKESIM_DEBUG.yaml"])
@pytest.mark.parametrize("run_type", ["train", "eval", "inference"])
def test_config_equals_run_py(tmp_path, monkeypatch, yaml, run_type):
    import ws_mgmap_tpu.train.trainer as jtrainer_mod

    monkeypatch.chdir(ROOT)  # the YAMLs name their task YAMLs from here
    for mod in (jbookkeeping, bookkeeping):
        monkeypatch.setattr(mod, "save_sh_n_codes", lambda *a, **k: None)
    monkeypatch.setattr(jtrainer_mod, "DaggerTrainer", Captured)
    monkeypatch.setattr(trainer_mod, "DaggerTrainer", Captured)
    opts = TINY_OPTS + ["EVAL.POLL_IDLE_TIMEOUT", "2.5", "DAGGER.LR", "0.001"]
    Captured.configs = []
    monkeypatch.delenv("WS_MGMAP_PLATFORM", raising=False)
    jax_run.run_exp(f"ws_mgmap_tpu/config/{yaml}", run_type,
                    str(tmp_path / "jax"), "note", opts, 0)
    monkeypatch.setenv("WS_MGMAP_PLATFORM", "cpu")
    port_run.main(["--run-type", run_type, "-c",
                   f"ws_mgmap_tpu_torch/config/{yaml}", "-e",
                   str(tmp_path / "port"), "--note", "note"] + opts)
    jcfg, pcfg = Captured.configs
    want, got = flatten(jcfg.to_dict()), flatten(pcfg.to_dict())
    assert sorted(got) == sorted(want)
    differ = {k for k in want if got[k] != want[k]}
    paths = {k for k in differ if isinstance(want[k], str)
             and str(tmp_path) in want[k]}
    for k in paths:  # the run dirs, under each package's model dir
        assert got[k] == want[k].replace(str(tmp_path / "jax"),
                                         str(tmp_path / "port")), k
    assert differ - paths == (PACKAGE_PATH_KEYS if yaml != "FAKESIM_DEBUG.yaml"
                              else set())
    if yaml != "FAKESIM_DEBUG.yaml":
        assert got["BASE_TASK_CONFIG_PATH"].startswith("ws_mgmap_tpu_torch/")
        assert os.path.isfile(got["BASE_TASK_CONFIG_PATH"])
    assert got["CHECKPOINT_FOLDER"].endswith(f"run_{run_type}_note/checkpoint")
    # the config dump is JSON of the same tree
    dump = tmp_path / "port" / f"run_{run_type}_note" / "config" / \
        f"config_of_{run_type}.txt"
    assert json.loads(dump.read_text()) == json.loads(json.dumps(
        pcfg.to_dict()))


class InProcess(trainer_mod.DaggerTrainer):
    """The CLI's trainer with its envs in process and no TensorBoard (an
    optional writer whose import brings in TensorFlow where it is
    installed)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, env_workers=False, **kwargs)

    def _tb(self):
        return None


def test_train_eval_inference_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # code.zip snapshots the working directory
    (tmp_path / "notes.txt").write_text("snapshot me\n")
    monkeypatch.setenv("WS_MGMAP_PLATFORM", "cpu")
    monkeypatch.setattr(trainer_mod, "DaggerTrainer", InProcess)
    model_dir = tmp_path / "model"
    base = ["-c", str(ROOT / "ws_mgmap_tpu_torch/config/FAKESIM_DEBUG.yaml"),
            "-e", str(model_dir)] + TINY_OPTS + [
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "30", "ep_max_len", "30"]
    port_run.main(["--run-type", "train"] + base)
    ckpts = model_dir / "run_train_base" / "checkpoint"
    assert sorted(os.listdir(ckpts)) == ["ckpt.0.pth"]

    port_run.main(["--run-type", "eval"] + base + [
        "EVAL_CKPT_PATH_DIR", str(ckpts), "EVAL.POLL_IDLE_TIMEOUT", "0.5"])
    metric = model_dir / "run_eval_base" / "metric"
    stats = json.loads((metric / "stats_ckpt_0_val_seen.json").read_text())
    each = json.loads((metric / "each_stat_ckpt_0_val_seen.json").read_text())
    assert len(each) == 2 and stats["steps_taken"] > 24

    pred = tmp_path / "predictions.json"
    port_run.main(["--run-type", "inference"] + base + [
        "INFERENCE.CKPT_PATH", str(ckpts / "ckpt.0.pth"),
        "INFERENCE.SPLIT", "val_seen", "INFERENCE.PREDICTIONS_FILE",
        str(pred)])
    predictions = json.loads(pred.read_text())
    assert len(predictions) == 2
    assert all(25 <= len(t) <= 30 for t in predictions.values())

    for run_type in ("train", "eval", "inference"):
        run_dir = model_dir / f"run_{run_type}_base"
        assert (run_dir / "config" / f"config_of_{run_type}.txt").is_file()
        codes = run_dir / "sh_n_codes"
        script = next(codes.glob(f"run_{run_type}_*.sh")).read_text()
        assert "export WS_MGMAP_PLATFORM=cpu" in script
        with zipfile.ZipFile(codes / "code.zip") as zf:
            names = zf.namelist()
        assert "notes.txt" in names and not any(
            n.startswith(f"model/run_{run_type}_base/") for n in names)


def test_cli_needs_a_card_or_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--run-type", "train", "-c",
            str(ROOT / "ws_mgmap_tpu_torch/config/FAKESIM_DEBUG.yaml"),
            "-e", str(tmp_path / "model")]
    monkeypatch.delenv("WS_MGMAP_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_run.main(argv)
    monkeypatch.setenv("WS_MGMAP_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="WS_MGMAP_PLATFORM"):
        port_run.main(argv)
    assert not (tmp_path / "model").exists()  # refused before any output
