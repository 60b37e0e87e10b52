"""The trainer (``train/trainer.py``) against the JAX package's, on the
CPU at the port's small end-to-end configuration
(``tools/synthetic.py::TINY_OPTS``) with in-process envs.

Held:
  * ``train`` over two DAgger iterations (beta 1, then 0.5): a rollout
    engine per iteration, the second one carrying the weights the first
    iteration trained (bit for bit: the engine copies them in fp32),
    rank-0 ``ckpt.<index>.pth`` files, the store topped up, eval-while-
    training once per iteration on the trained weights;
  * checkpoints cross the packages: the port's ``ckpt.*.pth`` loads into
    the JAX package with ``restore_variables`` and the JAX package's into
    the port, to the same tensors (exactly); ``resume`` gives the same
    (dagger_it, epoch) in both packages;
  * the pretrained chain (UNet checkpoint, the ImageNet resnet18 remap,
    the DD-PPO key rule, the instruction embeddings, ``LOAD_FROM_CKPT``)
    gives the JAX package's tensors exactly, and the same ImageNet count;
    with no file both packages warn that the backbones start from random
    init;
  * the mirrors of ``tests/test_eval_inference.py``: the poll order, new
    checkpoints picked up, eval-while-training re-raising on its second
    failure, and inference recording every episode exactly once.
"""
import copy
import functools
import gzip
import json
import os

import numpy as np
import pytest
import torch

from tests.torch_port_common import random_variables, tiny_configs
from ws_mgmap_tpu.models.policy import MGMapConfig as JMGMapConfig
from ws_mgmap_tpu.train import checkpoint as jckpt
from ws_mgmap_tpu.train.trainer import DaggerTrainer as JTrainer
from ws_mgmap_tpu.utils.convert import (
    import_imagenet_resnet18 as jimport_imagenet)
from ws_mgmap_tpu_torch.data.trajstore import TrajStoreReader
from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib
from ws_mgmap_tpu_torch.train import trainer as trainer_mod
from ws_mgmap_tpu_torch.train.trainer import DaggerTrainer, load_split
from ws_mgmap_tpu_torch.utils.convert import (from_jax_variables,
                                              import_imagenet_resnet18)

RGB_HW, DEPTH_HW = 64, 128  # TINY_OPTS' sensors
SHORT = ["ep_max_len", "36", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "36"]
TRAIN_OPTS = ["DAGGER.ITERATIONS", "2", "DAGGER.P", "0.5"] + SHORT
FROZEN = ("net.rgb_encoder.", "net.depth_encoder.")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch work on one CPU thread: the policy is small,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host_state(module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _template(mcfg: JMGMapConfig, seed: int) -> dict:
    return random_variables(mcfg, seed, RGB_HW, DEPTH_HW)


def jax_template(jcfg, seed: int = 5) -> dict:
    """Seeded JAX variables for ``jcfg``'s policy (a fresh copy: the JAX
    loaders write into the tree they are given)."""
    return copy.deepcopy(_template(JMGMapConfig.from_config(jcfg.MODEL),
                                   seed))


def assert_states_equal(got: dict, want: dict, skip=("num_batches_tracked",)):
    """Every tensor of ``want`` in ``got``, equal; keys ending in ``skip``
    left out (BN's update counter, which the JAX package has not)."""
    keys = [k for k in want if not k.endswith(skip)]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert torch.equal(got[k].to(want[k].dtype), want[k]), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's ``train`` with each iteration's engine weights and each
    eval-while-training call recorded (the eval itself left out: its
    failure rule is held below, its loop by ``test_torch_evaluator``), no
    TensorBoard (``test_torch_cli`` writes it)."""
    tmp = tmp_path_factory.mktemp("train")
    cfg, jcfg = tiny_configs(str(tmp), TRAIN_OPTS)
    trainer = DaggerTrainer(cfg, env_workers=False, device="cpu")
    seen = {"engines": [], "evals": []}
    real_collect = trainer_mod.collect_dataset

    def collect(config, engine, *a, **k):
        seen["engines"].append(host_state(engine.policy))
        return real_collect(config, engine, *a, **k)

    def eval_while_training(policy, tb, step):
        seen["evals"].append((step, host_state(policy)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "collect_dataset", collect)
        mp.setattr(trainer, "_eval_while_training", eval_while_training)
        mp.setattr(trainer, "_tb", lambda: None)
        metrics = trainer.train()
    return dict(cfg=cfg, jcfg=jcfg, metrics=metrics, **seen)


def test_train_two_iterations(trained):
    cfg = trained["cfg"]
    assert trained["metrics"] and all(np.isfinite(v) for v in
                                      trained["metrics"].values())
    assert sorted(os.listdir(cfg.CHECKPOINT_FOLDER)) == ["ckpt.0.pth",
                                                        "ckpt.1.pth"]
    r = TrajStoreReader(cfg.DAGGER.LMDB_FEATURES_DIR)
    assert len(r) == 2 * cfg.DAGGER.UPDATE_SIZE
    r.close()
    assert len(trained["engines"]) == 2
    assert [s for s, _ in trained["evals"]] == [0, 1]
    for i, (_, state) in enumerate(trained["evals"]):
        blob = ckpt_lib.load_checkpoint(
            os.path.join(cfg.CHECKPOINT_FOLDER, f"ckpt.{i}.pth"))
        assert blob["extra_state"] == {"dagger_it": i}
        assert blob["config"]["DAGGER"]["ITERATIONS"] == 2
        assert_states_equal(state, blob["state_dict"], skip=())


def test_second_iteration_engine_carries_trained_weights(trained):
    first, second = trained["engines"]
    ckpt0 = ckpt_lib.load_checkpoint(os.path.join(
        trained["cfg"].CHECKPOINT_FOLDER, "ckpt.0.pth"))["state_dict"]
    assert_states_equal(second, ckpt0, skip=())
    moved = [k for k in first if not torch.equal(first[k], second[k])]
    assert moved and not [k for k in moved if k.startswith(FROZEN)
                          and not k.endswith("num_batches_tracked")]


def test_port_checkpoint_loads_into_jax(trained):
    path = os.path.join(trained["cfg"].CHECKPOINT_FOLDER, "ckpt.1.pth")
    want = ckpt_lib.load_checkpoint(path)["state_dict"]
    variables, blob = jckpt.restore_variables(jax_template(trained["jcfg"]),
                                              path)
    assert blob["extra_state"] == {"dagger_it": 1}
    assert_states_equal(from_jax_variables(variables), want)


def test_jax_checkpoint_loads_into_port(trained, tmp_path):
    variables = jax_template(trained["jcfg"])
    path = str(tmp_path / "ckpt.3.pth")
    jckpt.save_checkpoint(path, variables, config=trained["jcfg"],
                          extra_state={"dagger_it": 1})
    policy = BasePolicy(MGMapConfig.from_config(trained["cfg"].MODEL))
    blob = ckpt_lib.restore(policy, path)
    assert blob["extra_state"] == {"dagger_it": 1}
    assert_states_equal(host_state(policy), from_jax_variables(variables))


@pytest.mark.parametrize("case", ["latest", "jax_file_mid_iteration"])
def test_resume_matches_jax(trained, tmp_path, case):
    cfg, jcfg = trained["cfg"].clone(), trained["jcfg"].clone()
    for c in (cfg, jcfg):
        c.defrost()
    jcfg.CHECKPOINT_FOLDER = cfg.CHECKPOINT_FOLDER  # the port's ckpts
    if case == "jax_file_mid_iteration":
        path = str(tmp_path / "ckpt.4.pth")
        jckpt.save_checkpoint(path, jax_template(jcfg), config=jcfg,
                              extra_state={"dagger_it": 2})
        for c in (cfg, jcfg):
            c.RESUME_CKPT = path
            c.DAGGER.EPOCHS = 3
    for c in (cfg, jcfg):
        c.freeze()
    variables, jit, jepoch = JTrainer(jcfg, env_workers=False).resume(
        jax_template(jcfg))
    policy = BasePolicy(MGMapConfig.from_config(cfg.MODEL))
    got = DaggerTrainer(cfg, env_workers=False, device="cpu").resume(policy)
    assert got == (jit, jepoch) == {"latest": (2, 0),
                                    "jax_file_mid_iteration": (2, 2)}[case]
    assert_states_equal(host_state(policy), from_jax_variables(variables))


# -- the pretrained chain ------------------------------------------------------
PRETRAINED_OPTS = ["MODEL.RGB_ENCODER.unet_width", "1.0"]  # ImageNet's shapes


def imagenet_state(policy, rng) -> dict:
    """A torchvision resnet18 state_dict for the policy's UNet, random
    values: the inverse of the JAX package's remap, plus ``fc`` and the
    BN counters, which the remap drops."""
    out = {"fc.weight": torch.randn(10, 512), "fc.bias": torch.randn(10)}
    prefix = "net.rgb_encoder.base_model."
    for k, v in policy.state_dict().items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        for ours, theirs in (("layer0.0.", "conv1."), ("layer0.1.", "bn1."),
                             ("layer1.1.", "layer1.")):
            if k.startswith(ours):
                k = theirs + k[len(ours):]
                break
        else:
            if not k.startswith(("layer2.", "layer3.", "layer4.")):
                continue
        out[k] = torch.from_numpy(np.asarray(rng.randn(*v.shape),
                                             np.float32)).to(v.dtype)
    return out


def write_pretrained(tmp, policy, rng, case: str) -> list:
    """The files of ``case`` under ``tmp``; returns the opts naming them
    (absent files keep their default, missing, paths)."""
    opts = []
    if case in ("unet", "load_ckpt"):
        sd = {f"module.model.{k[len('net.rgb_encoder.base_model.'):]}":
              torch.from_numpy(np.asarray(rng.randn(*v.shape),
                                          np.float32)).to(v.dtype)
              for k, v in policy.state_dict().items()
              if k.startswith("net.rgb_encoder.base_model.")}
        torch.save({"models": {"img_segm_model": sd}}, tmp / "unet.pt")
        opts += ["MODEL.RGB_ENCODER.pretrain_model", str(tmp / "unet.pt")]
    if case == "imagenet":
        torch.save(imagenet_state(policy, rng), tmp / "resnet18.pth")
        opts += ["MODEL.RGB_ENCODER.imagenet_resnet18",
                 str(tmp / "resnet18.pth")]
    if case in ("unet", "imagenet", "load_ckpt"):
        raw = {f"actor_critic.net.{k[len('net.depth_encoder.'):]}":
               torch.from_numpy(np.asarray(rng.randn(*v.shape), np.float32))
               for k, v in policy.state_dict().items()
               if k.startswith("net.depth_encoder.visual_encoder.")}
        raw["actor_critic.net.state_encoder.rnn.weight_ih_l0"] = torch.ones(3)
        raw["actor_critic.action_distribution.linear.weight"] = torch.ones(2)
        torch.save({"state_dict": raw}, tmp / "ddppo.pth")
        opts += ["MODEL.DEPTH_ENCODER.ddppo_checkpoint", str(tmp / "ddppo.pth")]
        vocab = policy.net.instruction_encoder.embedding_layer.weight.shape
        emb = rng.randn(*vocab).round(4)
        if case == "imagenet":  # a table of another shape is skipped
            emb = emb[:-1]
        with gzip.open(tmp / "emb.json.gz", "wt") as f:
            json.dump(emb.tolist(), f)
        opts += ["MODEL.INSTRUCTION_ENCODER.embedding_file",
                 str(tmp / "emb.json.gz")]
    if case == "load_ckpt":
        other = BasePolicy(policy.cfg)
        ckpt_lib.save_checkpoint(str(tmp / "ckpt.7.pth"), other)
        opts += ["DAGGER.LOAD_FROM_CKPT", "True", "DAGGER.CKPT_TO_LOAD",
                 str(tmp / "ckpt.7.pth")]
    return opts


@pytest.mark.parametrize("case", ["unet", "imagenet", "load_ckpt", "none"])
def test_pretrained_chain_matches_jax(tmp_path, case):
    base_cfg, _ = tiny_configs(str(tmp_path), PRETRAINED_OPTS)
    rng = np.random.RandomState(3)
    probe = BasePolicy(MGMapConfig.from_config(base_cfg.MODEL))
    opts = PRETRAINED_OPTS + write_pretrained(tmp_path, probe, rng, case)
    cfg, jcfg = tiny_configs(str(tmp_path), opts)
    variables = jax_template(jcfg)
    policy = BasePolicy(MGMapConfig.from_config(cfg.MODEL))
    policy.load_state_dict(from_jax_variables(variables), strict=True)
    before = host_state(policy)
    if case == "none":
        with pytest.warns(UserWarning, match="RANDOM init"):
            jvars = JTrainer(jcfg, env_workers=False)._load_pretrained(
                variables)
        with pytest.warns(UserWarning, match="RANDOM init"):
            DaggerTrainer(cfg, env_workers=False,
                          device="cpu")._load_pretrained(policy)
    else:
        jvars = JTrainer(jcfg, env_workers=False)._load_pretrained(variables)
        DaggerTrainer(cfg, env_workers=False,
                      device="cpu")._load_pretrained(policy)
    got = host_state(policy)
    assert_states_equal(got, from_jax_variables(jvars))
    floats = [k for k in got if got[k].is_floating_point()]
    changed = {k.split(".")[1] for k in floats
               if not torch.equal(got[k], before[k])}
    assert changed == {"unet": {"rgb_encoder", "depth_encoder",
                                "instruction_encoder"},
                       "imagenet": {"rgb_encoder", "depth_encoder",
                                    "map_decoder"},
                       "load_ckpt": {k.split(".")[1] for k in floats},
                       "none": set()}[case]


def test_imagenet_count_matches_jax(tmp_path):
    cfg, jcfg = tiny_configs(str(tmp_path), PRETRAINED_OPTS)
    variables = jax_template(jcfg)
    policy = BasePolicy(MGMapConfig.from_config(cfg.MODEL))
    sd = imagenet_state(policy, np.random.RandomState(0))
    _, want = jimport_imagenet(variables, {k: v.numpy()
                                           for k, v in sd.items()})
    assert import_imagenet_resnet18(policy, sd) == want > 100


# -- eval, inference ----------------------------------------------------------
def test_poll_order_is_index_ascending(tmp_path, monkeypatch):
    """``ckpt.10.pth`` is evaluated after ``ckpt.2.pth`` (the reference
    polls in index order, common_trainer.py:210-226)."""
    cfg, _ = tiny_configs(str(tmp_path))
    folder = tmp_path / "ckpts"
    folder.mkdir()
    for i in (10, 2, 0):
        (folder / f"ckpt.{i}.pth").write_bytes(b"x")
    trainer = DaggerTrainer(cfg, env_workers=False, device="cpu")
    seen = []
    monkeypatch.setattr(trainer, "_eval_one",
                        lambda path: (seen.append(os.path.basename(path))
                                      or {"ok": 1.0}))
    out = trainer.eval(str(folder), idle_timeout_s=0.5)
    assert seen == ["ckpt.0.pth", "ckpt.2.pth", "ckpt.10.pth"]
    assert out == {"ok": 1.0}


def test_poll_picks_up_new_checkpoints(tmp_path, monkeypatch):
    cfg, _ = tiny_configs(str(tmp_path))
    folder = tmp_path / "ckpts"
    folder.mkdir()
    (folder / "ckpt.0.pth").write_bytes(b"x")
    trainer = DaggerTrainer(cfg, env_workers=False, device="cpu")
    seen = []

    def fake_eval(path):
        seen.append(os.path.basename(path))
        if len(seen) == 1:  # a new checkpoint appears while polling
            (folder / "ckpt.1.pth").write_bytes(b"x")
        return {"n": float(len(seen))}

    monkeypatch.setattr(trainer, "_eval_one", fake_eval)
    trainer.eval(str(folder), idle_timeout_s=0.5)
    assert seen == ["ckpt.0.pth", "ckpt.1.pth"]


def test_eval_while_training_reraises_on_repeat_failure(tmp_path,
                                                        monkeypatch):
    cfg, _ = tiny_configs(str(tmp_path))
    trainer = DaggerTrainer(cfg, env_workers=False, device="cpu")
    logs = []
    monkeypatch.setattr(trainer, "_log", logs.append)

    def boom(*a, **k):
        raise RuntimeError("eval path broken")

    monkeypatch.setattr(trainer_mod, "load_split", boom)
    trainer._eval_while_training(policy=None, tb=None, step=0)  # swallowed
    assert "eval-while-training failed (1 consecutive)" in logs[0]
    assert "RuntimeError: eval path broken" in logs[0]  # the traceback
    with pytest.raises(RuntimeError, match="eval path broken"):
        trainer._eval_while_training(policy=None, tb=None, step=1)


def test_inference_covers_every_episode_once(tmp_path):
    """Inference dumps one trajectory per split episode and ends when the
    env iterators cycle (2 envs in process, 3 episodes on 2 scenes of at
    most 30 steps: the second env pauses and the batch falls to 1)."""
    cfg, _ = tiny_configs(str(tmp_path), [
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "30",
        "TASK_CONFIG.DATASET.FAKE_EPISODES", "3",
        "INFERENCE.SPLIT", "val_seen",
        "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "predictions.json"),
        "EVAL.EPISODE_COUNT", "100"])  # more than the split holds
    out_path = DaggerTrainer(cfg, env_workers=False,
                             device="cpu").inference()
    with open(out_path) as f:
        predictions = json.load(f)
    dataset, _ = load_split(cfg, "val_seen")
    assert sorted(predictions) == sorted(str(e.episode_id)
                                         for e in dataset.episodes)
    for ep_id, traj in predictions.items():
        assert 25 <= len(traj) <= 30, (ep_id, len(traj))
        for stepinfo in traj[:2]:
            assert "position" in stepinfo and "stop" in stepinfo, stepinfo
