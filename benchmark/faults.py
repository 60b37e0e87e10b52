"""Faults planted under the timed path, to show that ``correct`` catches
them: a step that leaves its state unchanged, half of the batch left
out, and a token or an answer altered where it is produced. Used by the
tests and by ``controls.py``; never by a benchmark run."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def rollout_state_unchanged():
    """Each engine step returns its outputs but keeps the global map and
    the hidden state it had."""
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    def make(orig):
        def step(self, *a, **k):
            g, h = self.global_map.clone(), self.hidden.clone()
            out = orig(self, *a, **k)
            self.global_map, self.hidden = g, h
            return out
        return step

    with patched(RolloutEngine, "act", make), \
            patched(RolloutEngine, "update_map", make):
        yield


@contextlib.contextmanager
def rollout_answer_altered(delta: float = 0.05):
    """``act`` returns env 0's waypoint moved by ``delta``."""
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    def make(orig):
        def act(self, *a, **k):
            out = orig(self, *a, **k)
            out.action[0] += delta
            return out
        return act

    with patched(RolloutEngine, "act", make):
        yield


@contextlib.contextmanager
def train_state_unchanged():
    """The update computes its loss but never steps the optimiser."""
    from ws_mgmap_tpu_torch.train import step as step_mod

    def make(orig):
        def make_train_step(*a, **k):
            update = orig(*a, **k)

            def frozen(state, batch):
                step = state.optimizer.step
                state.optimizer.step = lambda *x, **y: None
                try:
                    return update(state, batch)
                finally:
                    state.optimizer.step = step
            return frozen
        return make_train_step

    with patched(step_mod, "make_train_step", make):
        yield


@contextlib.contextmanager
def train_half_batch():
    """The update sees the first half of each batch's episodes, and its
    means are over those."""
    from ws_mgmap_tpu_torch.train import step as step_mod

    def cut(batch):
        n = batch["weights"].shape[0] // 2
        out = {k: v[:n] for k, v in batch.items() if k != "obs"}
        out["obs"] = {k: v[:n] for k, v in batch["obs"].items()}
        return out

    def make(orig):
        def make_train_step(*a, **k):
            update = orig(*a, **k)
            return lambda state, batch: update(state, cut(batch))
        return make_train_step

    with patched(step_mod, "make_train_step", make):
        yield


@contextlib.contextmanager
def train_token_altered():
    """The loader's collate changes the first token of the first episode
    of each batch."""
    from ws_mgmap_tpu_torch.train import replay

    def make(orig):
        def collate(*a, **k):
            out = orig(*a, **k)
            tok = out["obs"]["instruction"]
            tok[0, :, 0] = tok[0, :, 0] % 2000 + 1
            return out
        return collate

    with patched(replay, "collate_episodes", make):
        yield


ROLLOUT = {"state_unchanged": rollout_state_unchanged,
           "answer_altered": rollout_answer_altered}
TRAIN = {"state_unchanged": train_state_unchanged,
         "half_batch": train_half_batch,
         "token_altered": train_token_altered}
