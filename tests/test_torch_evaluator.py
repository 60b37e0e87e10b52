"""Checkpoint evaluation, the slice as a whole: the port's ``evaluate``
over its ``RolloutEngine`` against the JAX package's ``evaluate`` over its
engine, on the same weights and the same FakeSim split.

Small widths (``tests/torch_port_common.py``) with the sim's RGB and
depth sized to them, fp32, in process (``workers=False``), 2 envs, 4
episodes on 3 scenes and a 30-step cap: one env holds 3 episodes and the
other 1. The progress threshold, -0.040, lies between the two envs'
prog at the first decision after the 24-step look-around (-0.0392 and
-0.0411 with these weights): the second env stops there and is paused
mid-episode of the first (the engine drops its slot with ``keep``,
carrying the first env's hidden state and global map, and re-encodes
the instructions), which runs on alone to the cap; later rounds run the
first env alone, its next episode stopping at its first decision.
Held: the per-episode metrics and both metric JSONs equal, every
decision's waypoint within the fp32 tolerance of ``test_torch_act.py``,
the same batch sizes and the same number of instruction encodes.
The weights are drawn in numpy for the variables' shapes (JAX's
``eval_shape``): no compile of ``init``.
"""
import json

import numpy as np
import pytest

from tests.torch_port_common import (DEPTH_HW, RGB_HW, jax_config,
                                     port_policy, random_variables)
from ws_mgmap_tpu.config.default import get_config as jget_config
from ws_mgmap_tpu.env import dataset as jdataset
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.train.evaluator import evaluate as jevaluate
from ws_mgmap_tpu.train.rollout import RolloutEngine as JEngine
from ws_mgmap_tpu_torch.config.default import get_config
from ws_mgmap_tpu_torch.env import dataset
from ws_mgmap_tpu_torch.env.vector_env import construct_envs
from ws_mgmap_tpu_torch.train.evaluator import evaluate
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

B = 2
SCENES = ["fake/a", "fake/b", "fake/c"]
CAP = 30
PROG_THRESHOLD = -0.040


def _config(get):
    cfg = get()
    cfg.NUM_PROCESSES = B
    cfg.EVAL.EPISODE_COUNT = 4
    cfg.STOP_CONDITION.PROG_THRESHOLD = PROG_THRESHOLD
    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = CAP
    cfg.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
    # the loop reads neither the GT semantic map nor the path sensor
    cfg.TASK_CONFIG.TASK.SENSORS = [
        s for s in cfg.TASK_CONFIG.TASK.SENSORS
        if s not in ("GT_SEMANTIC_MAP_SENSOR", "VLN_ORACLE_PATH_SENSOR")]
    s = cfg.TASK_CONFIG.SIMULATOR
    s.RGB_SENSOR.WIDTH = s.RGB_SENSOR.HEIGHT = RGB_HW
    s.DEPTH_SENSOR.WIDTH = s.DEPTH_SENSOR.HEIGHT = DEPTH_HW
    cfg.freeze()
    return cfg


def _record(engine, encoder_owner, encoder_name: str, act_of) -> dict:
    """Wrap the engine's act and its text encoder to record each
    decision's waypoints and batch size, and the encodes."""
    record = {"actions": [], "batch": [], "encodes": 0}
    real_act = engine.act
    real_encode = getattr(encoder_owner, encoder_name)

    def act(batch, masks, **kw):
        out = real_act(batch, masks, **kw)
        record["actions"].append(act_of(out))
        record["batch"].append(len(masks))
        return out

    def encode(*a, **k):
        record["encodes"] += 1
        return real_encode(*a, **k)

    engine.act = act
    setattr(encoder_owner, encoder_name, encode)
    return record


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    variables = random_variables(jax_config(), 3)
    jeng = JEngine(JPolicy(jax_config()), variables, B)
    teng = RolloutEngine(port_policy(variables), B, device="cpu")
    out = {}
    for name, fn, get, ds_mod, record in (
            ("jax", jevaluate, jget_config, jdataset,
             _record(jeng, jeng, "_encode_text",
                     lambda o: np.asarray(o.action))),
            ("port", evaluate, get_config, dataset,
             _record(teng, teng.policy, "encode_text",
                     lambda o: o.action.cpu().numpy()))):
        eng = jeng if name == "jax" else teng
        ds = ds_mod.make_fake_dataset(4, SCENES, seed=3)
        gt = ds_mod.fake_gt_locations(ds)
        cfg = _config(get)
        kw = {}
        if name == "port":  # the port's loop on a vector env built for it
            kw["envs"] = construct_envs(cfg, ds, gt, auto_reset_done=False,
                                        workers=False)
            real_close = kw["envs"].close
            record["closed"] = 0

            def close():
                record["closed"] += 1
                real_close()
            kw["envs"].close = close
        metric_dir = tmp_path_factory.mktemp(name)
        logs = []
        agg = fn(cfg, eng, ds, gt, workers=False, log_fn=logs.append,
                 metric_dir=str(metric_dir), checkpoint_index=7,
                 split="val_seen", **kw)
        out[name] = dict(record, agg=agg, logs=logs, dir=metric_dir)
    return out


def test_metrics_equal_jax(runs):
    jax_run, port = runs["jax"], runs["port"]
    assert port["closed"] == 1  # evaluate closed the envs it was given
    assert port["agg"] == jax_run["agg"]
    assert port["logs"] == jax_run["logs"]
    for name in ("stats_ckpt_7_val_seen.json",
                 "each_stat_ckpt_7_val_seen.json"):
        got = json.loads((port["dir"] / name).read_text())
        want = json.loads((jax_run["dir"] / name).read_text())
        assert got == want, name
    each = json.loads((port["dir"] / "each_stat_ckpt_7_val_seen.json")
                      .read_text())
    assert sorted(each) == ["0", "1", "2", "3"]
    # the stop rule ended three episodes at their first decision, the
    # fourth ran on alone to the cap
    assert sorted(m["steps_taken"] for m in each.values()) == [25.0] * 3 + [
        float(CAP)]
    for key in ("distance_to_goal", "success", "spl", "ndtw", "path_length",
                "oracle_success", "oracle_navigation_error", "oracle_spl",
                "steps_taken", "sdtw"):
        assert np.isfinite(port["agg"][key]), key


def test_decisions_equal_jax(runs):
    jax_run, port = runs["jax"], runs["port"]
    # two envs, then one mid-episode: the paused env's slot was dropped
    assert port["batch"] == jax_run["batch"]
    assert port["batch"][:2] == [B, 1] and port["batch"][-1] == 1
    # the first act of each round and the act after keep() re-encode
    assert port["encodes"] == jax_run["encodes"] >= 3
    assert len(port["actions"]) == len(jax_run["actions"])
    for t, (got, want) in enumerate(zip(port["actions"],
                                        jax_run["actions"])):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5,
                                   err_msg=f"decision {t}")


def test_video_option_raises(tmp_path):
    """Before it builds an env or touches the engine (none is given)."""
    cfg = _config(get_config)
    cfg.defrost()
    cfg.VIDEO_OPTION = ["disk"]
    with pytest.raises(NotImplementedError, match="VIDEO_OPTION"):
        evaluate(cfg, None, dataset.VLNCEDataset([]), {}, workers=False,
                 metric_dir=str(tmp_path))
    assert not any(tmp_path.iterdir())
