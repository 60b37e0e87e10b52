"""The eval decision protocol, as each of its callers runs it: the
checkpoint eval (``evaluate``), the leaderboard dump
(``DaggerTrainer.inference``) and the policy probe
(``tools/diag_policy_probe.probe``). No model and no JAX: a stub engine
and fake envs on the port's in-process ``VectorEnv``.

Three envs, five episodes of fixed lengths: env 0 holds a0 (28 steps)
and a1 (33), env 1 b0 (36), env 2 c0 and c1 (30 each). In the first
round a0 ends between two decisions and c0 at one, and their envs
pause; b0 runs on alone. In the second, env 1's next episode is b0
again and it pauses at once; c1 ends and a1 runs on alone. The env
checks every step input it gets (the four keys, the oracle waypoint
during the look-around and its own row's action and progress after it,
its own depth); the engine checks that the rows and masks it is fed
are those of the envs it holds. Held: the decisions at the same steps
on the same rows, the same pauses, and each observer's per-episode
record made of that episode's steps alone.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ws_mgmap_tpu_torch.env import vector_env, viz
from ws_mgmap_tpu_torch.env.vector_env import VectorEnv
from ws_mgmap_tpu_torch.tools import diag_policy_probe
from ws_mgmap_tpu_torch.tools.synthetic import tiny_config
from ws_mgmap_tpu_torch.train import trainer as trainer_mod
from ws_mgmap_tpu_torch.train.evaluator import evaluate

EPISODES = [[("a0", 28), ("a1", 33)], [("b0", 36)], [("c0", 30), ("c1", 30)]]
LENGTHS = dict(ep for eps in EPISODES for ep in eps)
KEYS = {"action", "prog", "epidsode_reset_flag", "depth_img"}
# (episodes of the rows, step) of every act, in order
ACTS = [(("a0", "b0", "c0"), 24), (("a0", "b0", "c0"), 27), (("b0",), 30),
        (("b0",), 33), (("a1", "c1"), 24), (("a1", "c1"), 27),
        (("a1",), 30)]
# (episode, step) of every env paused, in order; after the last round
# every env resets onto a recorded episode and pauses
PAUSES = [("a0", 28), ("c0", 30), ("b0", 0), ("c1", 30),
          ("c0", 0), ("b0", 0), ("a0", 0)]


def code(slot: int) -> np.ndarray:
    """Env ``slot``'s action after the look-around; its oracle waypoint
    is the tanh of it, and its progress the first entry."""
    return np.asarray([0.1 * (slot + 1), -0.05 * (slot + 1)], np.float32)


class FakeEnv:
    def __init__(self, slot: int):
        self.slot = slot
        self.episodes = [SimpleNamespace(episode_id=e, length=n,
                                         instruction={"instruction_text": ""})
                         for e, n in EPISODES[slot]]
        self.index = -1

    def current_episode(self):
        return self.episodes[self.index]

    def _obs(self):
        c = code(self.slot)
        return {"slot": self.slot, "episode": self.current_episode().episode_id,
                "t": self.t, "waypoint": np.tanh(c), "progress": c[:1],
                "depth": np.full((2, 2, 1), 100 * self.slot + self.t,
                                 np.float32)}

    def reset(self):
        self.index = (self.index + 1) % len(self.episodes)
        self.t = 0
        return self._obs()

    def step(self, inp):
        assert KEYS <= set(inp), sorted(inp)
        c = code(self.slot)
        np.testing.assert_array_equal(
            inp["action"], np.tanh(c) if self.t < 24 else c)
        assert inp["prog"] == (-1 if self.t < 24 else c[0])
        assert inp["epidsode_reset_flag"] == (self.t == 0)
        np.testing.assert_array_equal(inp["depth_img"], self._obs()["depth"])
        self.t += 1
        done = self.t == self.current_episode().length
        return (self._obs(), 0.0, done,
                {"slot": float(self.slot), "t": float(self.t)})


class FakeEnvs(VectorEnv):
    def __init__(self):
        super().__init__([(FakeEnv, (s,)) for s in range(len(EPISODES))],
                         workers=False)
        self.paused = []

    def pause_at(self, index):
        env = self._envs[self._conns[index]]
        self.paused.append((env.current_episode().episode_id, env.t))
        super().pause_at(index)


class StubEngine:
    """Acts with each row's env code. After ``reset_state`` (all envs
    resumed) row i is env i; ``keep`` re-indexes the rows."""

    def __init__(self):
        self.acts = []

    def reset_state(self, n):
        self.rows = list(range(n))
        self.prog = np.zeros((n, 1), np.float32)

    def batch_obs(self, observations):
        return observations

    def _check(self, batch, masks):
        assert [o["slot"] for o in batch] == self.rows
        assert len({o["t"] for o in batch}) == 1
        np.testing.assert_array_equal(  # every env goes on until it pauses
            masks, np.full((len(batch), 1), batch[0]["t"] > 0, np.float32))

    def act(self, batch, masks):
        self._check(batch, masks)
        t = batch[0]["t"]
        assert t >= 24 and t % 3 == 0
        self.acts.append((tuple(o["episode"] for o in batch), t))
        codes = np.stack([code(s) for s in self.rows])
        self.prog = codes[:, :1].copy()
        n = len(batch)
        return SimpleNamespace(
            action=torch.from_numpy(codes), prog=torch.from_numpy(self.prog),
            att_map=torch.from_numpy(codes[:, :1]).expand(n, 4),
            pred_sem_map=torch.zeros((n, 2, 2, 3)))

    def update_map(self, batch, masks):
        self._check(batch, masks)
        t = batch[0]["t"]
        assert t < 24 or t % 3 != 0

    def keep(self, keep):
        self.rows = [self.rows[i] for i in keep]
        self.prog = self.prog[keep]


def config(tmp_path):
    return tiny_config(str(tmp_path), [
        "NUM_PROCESSES", "3", "EVAL.EPISODE_COUNT", "5",
        "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "predictions.json")])


def run_evaluate(tmp_path, monkeypatch, engine, envs):
    """Each video's frames, as (slot, step) of the observation drawn."""
    cfg = config(tmp_path)
    cfg.defrost()
    cfg.VIDEO_OPTION = ["disk"]
    cfg.VIDEO_DIR = str(tmp_path / "videos")
    cfg.freeze()

    def frame(obs, att_map=None, pred_sem_map=None, info=None):
        if att_map is not None:  # the last decision of this env's row
            assert att_map[0] == code(obs["slot"])[0]
        assert info == {"slot": obs["slot"], "t": obs["t"]}
        return (obs["slot"], obs["t"])

    videos = {}

    def write(video_dir, frames, episode_id, **kw):
        assert episode_id not in videos
        videos[episode_id] = list(frames)

    monkeypatch.setattr(viz, "observations_to_image", frame)
    monkeypatch.setattr(viz, "append_text_to_image", lambda f, text: f)
    monkeypatch.setattr(viz, "generate_video", write)
    evaluate(cfg, engine, None, None, episode_count=5, envs=envs,
             log_fn=lambda *a: None)
    return videos


def run_inference(tmp_path, monkeypatch, engine, envs):
    """Each episode's trajectory, as (slot, step) of its infos."""
    cfg = config(tmp_path)
    episodes = [e for eps in EPISODES for e in eps]
    monkeypatch.setattr(trainer_mod, "load_split", lambda c, split: (
        SimpleNamespace(episodes=episodes), None))
    monkeypatch.setattr(vector_env, "construct_envs", lambda *a, **k: envs)
    monkeypatch.setattr(trainer_mod.DaggerTrainer, "init_policy",
                        lambda self: None)
    monkeypatch.setattr(trainer_mod.DaggerTrainer, "_engine",
                        lambda self, policy, n: engine)
    path = trainer_mod.DaggerTrainer(cfg, env_workers=False,
                                     device="cpu").inference()
    with open(path) as f:
        return {k: [(int(i["slot"]), int(i["t"])) for i in v]
                for k, v in json.load(f).items()}


def run_probe(tmp_path, monkeypatch, engine, envs):
    """Each episode's final step; the rows' decisions held exact."""
    wp_err, prog_err, cos_sims, recs, stats = diag_policy_probe.probe(
        config(tmp_path), engine, envs, 5)
    assert len(wp_err) == len(prog_err) == sum(len(r) for r, _ in ACTS)
    assert max(wp_err) == max(map(abs, prog_err)) == 0
    assert cos_sims and all(abs(c - 1) < 1e-6 for c in cos_sims)
    assert [r["step"] for r in recs] == [t for _, t in ACTS]
    return {k: [(int(i["slot"]), int(i["t"]))] for k, i in stats.items()}


@pytest.mark.parametrize("run", [run_evaluate, run_inference, run_probe],
                         ids=["evaluate", "inference", "probe"])
def test_eval_protocol(tmp_path, monkeypatch, run):
    engine, envs = StubEngine(), FakeEnvs()
    records = run(tmp_path, monkeypatch, engine, envs)
    assert engine.acts == ACTS
    assert envs.paused == PAUSES
    slot = {e: s for s, eps in enumerate(EPISODES) for e, _ in eps}
    assert sorted(records) == sorted(LENGTHS)
    for ep, steps in records.items():
        want = [(slot[ep], t) for t in range(1, LENGTHS[ep] + 1)]
        assert steps == (want[-1:] if run is run_probe else want), ep
