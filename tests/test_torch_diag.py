"""The port's rollout diagnostics against the JAX package's (CPU):
``diag_oracle_rollout`` (the oracle's ceiling) here, and
``diag_policy_probe`` in ``test_torch_diag_probe.py``.

Both packages' learning-check configs are cut the same way to keep the
runs short (``short``): 2 envs and episodes of at most 30 steps (the
24-step look-around and two decisions). Held: the oracle rollout's JSON
is equal.
"""
import contextlib
import io
import json
import sys

import pytest
import torch

import tools.diag_oracle_rollout as jdiag_oracle
import tools.learning_check as jlearning_check
from ws_mgmap_tpu_torch.tools import diag_oracle_rollout, learning_check

MAX_STEPS = 30


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _short(tiny_config):
    def cut(*args, **kwargs):
        cfg = tiny_config(*args, **kwargs)
        cfg.defrost()
        cfg.NUM_PROCESSES = 2
        cfg.ep_max_len = MAX_STEPS
        cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = MAX_STEPS
        cfg.freeze()
        return cfg
    return cut


@pytest.fixture()
def short(monkeypatch):
    monkeypatch.setattr(jlearning_check, "tiny_config",
                        _short(jlearning_check.tiny_config))
    monkeypatch.setattr(learning_check, "tiny_config",
                        _short(learning_check.tiny_config))
    monkeypatch.setenv("WS_MGMAP_PLATFORM", "cpu")


def _json(module, argv):
    out = io.StringIO()
    old = sys.argv
    sys.argv = [module.__name__] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = old
    text = out.getvalue()
    return json.loads(text[text.index("\n{") + 1 if not text.startswith("{")
                           else 0:])


def test_oracle_rollout_equals_jax(short):
    args = ["--episodes", "1", "--max-steps", MAX_STEPS, "--seed", "7",
            "--split", "val_unseen"]
    want = _json(jdiag_oracle, args)
    got = _json(diag_oracle_rollout, args + ["--in-process"])
    assert got == want
    assert got["n"] >= 1
