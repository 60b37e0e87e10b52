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

With ``VIDEO_OPTION ["disk"]`` (and the semantic sensors a video eval
adds) both packages' runs give the metrics of the runs without video;
each episode's PNG directory has the JAX name and a frame a step, and
the frames' rgb and first-person semantic panels equal JAX's exactly.
The slot bookkeeping across pauses is held with a stub engine, as
``tests/test_viz.py`` holds JAX's.
"""
import os
import json

import cv2
import numpy as np
import pytest
import torch

from tests.torch_port_common import (DEPTH_HW, RGB_HW, jax_config,
                                     port_policy, random_variables)
import ws_mgmap_tpu.env.viz as jviz
from ws_mgmap_tpu.config.default import get_config as jget_config
from ws_mgmap_tpu.env import dataset as jdataset
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.train.evaluator import evaluate as jevaluate
from ws_mgmap_tpu.train.rollout import RolloutEngine as JEngine
from ws_mgmap_tpu_torch.config.default import get_config
from ws_mgmap_tpu_torch.env import dataset, viz
from ws_mgmap_tpu_torch.env.vector_env import construct_envs
from ws_mgmap_tpu_torch.train.evaluator import evaluate
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

B = 2
SCENES = ["fake/a", "fake/b", "fake/c"]
CAP = 30
PROG_THRESHOLD = -0.040


def _config(get, video_dir=None):
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
    if video_dir:
        # as the trainers' video evals set it up
        cfg.VIDEO_OPTION = ["disk"]
        cfg.VIDEO_DIR = str(video_dir)
        cfg.TASK_CONFIG.TASK.SENSORS = (list(cfg.TASK_CONFIG.TASK.SENSORS)
                                        + ["SEMANTIC_FILTER_SENSOR"])
        s.AGENT_0.SENSORS = list(s.AGENT_0.SENSORS) + ["SEMANTIC_SENSOR"]
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the suite runs test files side by side, where
    torch's own threads slow these many small ops down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoCodec:
    """``cv2.VideoWriter`` without a codec: the JAX package then writes
    its PNG directory."""

    def __init__(self, *a, **k):
        pass

    def isOpened(self):
        return False


@pytest.fixture(scope="module")
def engines():
    variables = random_variables(jax_config(), 3)
    jeng = JEngine(JPolicy(jax_config()), variables, B)
    teng = RolloutEngine(port_policy(variables), B, device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def video_runs(engines, tmp_path_factory):
    """Both packages' evaluations with videos on disk."""
    jeng, teng = engines
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jviz.cv2, "VideoWriter", _NoCodec)
        for name, fn, get, ds_mod, eng in (
                ("jax", jevaluate, jget_config, jdataset, jeng),
                ("port", evaluate, get_config, dataset, teng)):
            ds = ds_mod.make_fake_dataset(4, SCENES, seed=3)
            gt = ds_mod.fake_gt_locations(ds)
            videos = tmp_path_factory.mktemp(name + "_videos")
            metric_dir = tmp_path_factory.mktemp(name + "_video_metrics")
            agg = fn(_config(get, videos), eng, ds, gt, workers=False,
                     log_fn=lambda *a: None, metric_dir=str(metric_dir),
                     checkpoint_index=7, split="val_seen")
            each = json.loads((metric_dir / "each_stat_ckpt_7_val_seen.json")
                              .read_text())
            out[name] = dict(agg=agg, videos=videos, each=each)
    return out


@pytest.fixture(scope="module")
def runs(engines, tmp_path_factory):
    jeng, teng = engines
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
    """``VIDEO_OPTION`` no longer raises: the loop starts, and only the
    missing engine (none is given) raises, before a file is written."""
    cfg = _config(get_config, tmp_path / "videos")
    with pytest.raises(AttributeError, match="reset_state"):
        evaluate(cfg, None, dataset.make_fake_dataset(1, SCENES, seed=3),
                 {}, workers=False, metric_dir=str(tmp_path))
    assert not any(tmp_path.iterdir())


def _panels(path):
    img = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    return img[:240, :480]   # the rgb and first-person semantic panels


def test_video_eval_equals_jax(runs, video_runs):
    port, jax_run = video_runs["port"], video_runs["jax"]
    assert port["agg"] == runs["port"]["agg"] == jax_run["agg"]
    assert port["each"] == jax_run["each"]
    names = sorted(os.listdir(port["videos"]))
    assert names == sorted(os.listdir(jax_run["videos"]))
    assert len(names) == 4
    for ep, m in port["each"].items():
        name = f"episode={ep}-ckpt=7-spl={m['spl']:.2f}"
        frames = sorted(os.listdir(port["videos"] / name))
        assert frames == sorted(os.listdir(jax_run["videos"] / name))
        assert len(frames) == m["steps_taken"], name   # a frame a step
        for f in frames:
            np.testing.assert_array_equal(
                _panels(port["videos"] / name / f),
                _panels(jax_run["videos"] / name / f))
        last = cv2.imread(str(port["videos"] / name / frames[-1]))
        # after a decision: rgb | semantics | map | heatmap | legend
        assert last.shape == (280, 4 * 240 + 120, 3)


class _StubOut:
    def __init__(self, n):
        self.action = torch.zeros((n, 2))
        self.att_map = torch.zeros((n, 16), dtype=torch.bfloat16)
        self.pred_sem_map = torch.zeros((n, 4, 4, 27), dtype=torch.bfloat16)


class _StubEngine:
    """Env slot 0 stops early via prog (> threshold after step 26), the
    others run to max steps: slot 0 exhausts its episodes and PAUSES while
    the others go on (``tests/test_viz.py``'s scenario)."""

    def __init__(self):
        self.num_envs = 0
        self.steps = 0
        self.early = True  # applies to current index 0 before a pause
        self.kept = []

    def reset_state(self, n):
        self.num_envs = n
        self.prog = np.zeros((n, 1), np.float32)
        self.steps = 0

    def batch_obs(self, obs):
        return obs

    def act(self, batch, masks):
        self.steps += 3
        n = len(batch)
        self.prog = np.zeros((n, 1), np.float32)
        if self.early and self.steps > 26 and n > 1:
            self.prog[0, 0] = 0.99  # stop current env 0
        return _StubOut(n)

    def update_map(self, batch, masks):
        return None

    def keep(self, keep_indices):
        self.kept.append(list(keep_indices))
        self.num_envs = len(keep_indices)
        self.prog = self.prog[list(keep_indices)]
        if 0 not in keep_indices:
            self.early = False


@pytest.mark.parametrize("video_num", [99999, 2])
def test_eval_video_slots_survive_pauses(tmp_path, monkeypatch, video_num):
    """After ``pause_at`` re-indexes the envs, frames keep going to the
    buffer of the env's own slot: one episode a video, none mixed;
    ``VIDEO_NUM`` caps the count."""
    cfg = _config(get_config, tmp_path / "videos")
    cfg.defrost()
    cfg.VIDEO_NUM = video_num
    cfg.STOP_CONDITION.PROG_THRESHOLD = 0.5   # only the stub's 0.99 stops
    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = 40
    cfg.freeze()
    ds = dataset.make_fake_dataset(4, SCENES, seed=3)
    gt = dataset.fake_gt_locations(ds)

    def sig_of_tokens(tokens):
        return int(np.asarray(tokens).sum()) % 251

    ep_sig = {e.episode_id: sig_of_tokens(
        e.instruction["instruction_tokens"]) for e in ds.episodes}
    assert len(set(ep_sig.values())) == len(ep_sig)

    # frames carry the source episode's signature in pixel (0,0,0)
    def fake_frame(obs, sim=None, pred_sem_map=None, att_map=None,
                   waypoint_world=None, tile=240, info=None):
        assert att_map is None or att_map.dtype == np.float32
        return np.full((2, 2, 3), sig_of_tokens(obs["instruction"]["tokens"]),
                       np.uint8)

    captured = []
    monkeypatch.setattr(viz, "observations_to_image", fake_frame)
    monkeypatch.setattr(viz, "append_text_to_image", lambda img, text: img)
    monkeypatch.setattr(viz, "generate_video",
                        lambda video_dir, frames, episode_id, **kw:
                        captured.append((episode_id,
                                         [int(f[0, 0, 0]) for f in frames])))
    engine = _StubEngine()
    evaluate(cfg, engine, ds, gt, episode_count=4, workers=False,
             log_fn=lambda *a, **k: None)
    assert engine.kept, "no env paused"
    assert len(captured) == min(4, video_num)
    for episode_id, sigs in captured:
        assert len(set(sigs)) == 1, (episode_id, sigs)
        assert sigs[0] == ep_sig[episode_id], episode_id
    assert len({e for e, _ in captured}) == len(captured)
