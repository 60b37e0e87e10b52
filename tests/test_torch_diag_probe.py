"""The port's ``diag_policy_probe`` against the JAX package's (CPU): the
probe of the same checkpoint (the port's, which both packages load),
under the cut configs of ``test_torch_diag.py``, makes the same
decisions, its errors and measures within 1e-4 and its trace (rounded to
3 decimals by both tools) within 1.5e-3. Most of its time is JAX's
compile of the small policy.
"""
import numpy as np
import pytest
import torch

import tools.diag_policy_probe as jdiag_probe
from tests.test_torch_diag import _json, short  # noqa: F401 (fixture)
from ws_mgmap_tpu_torch.tools import diag_policy_probe, learning_check
from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib
from ws_mgmap_tpu_torch.train import trainer as trainer_mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_policy_probe_equals_jax(short, tmp_path):
    cfg = learning_check.tiny_config(str(tmp_path), 2, 1)
    policy = trainer_mod.DaggerTrainer(cfg, env_workers=False,
                                       device="cpu").init_policy()
    ckpt = tmp_path / "ckpt.0.pth"
    ckpt_lib.save_checkpoint(str(ckpt), policy, cfg)
    want = _json(jdiag_probe, [ckpt, "--episodes", "1"])
    got = _json(diag_policy_probe, [ckpt, "--episodes", "1", "--in-process"])
    assert (got["n_eps"], got["n_decisions"]) == \
        (want["n_eps"], want["n_decisions"])
    assert got["n_decisions"] > 0
    for k in ("wp_l2_mean", "wp_l2_p50", "wp_cos_mean", "prog_err_mean",
              "prog_err_std"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert got["agg"].keys() == want["agg"].keys()
    for k, v in want["agg"].items():
        np.testing.assert_allclose(got["agg"][k], v, atol=1e-4, err_msg=k)
    assert len(got["first_episode_trace"]) == len(want["first_episode_trace"])
    for g, w in zip(got["first_episode_trace"], want["first_episode_trace"]):
        assert g["step"] == w["step"]
        for k in ("pred_wp", "oracle_wp", "pred_prog", "oracle_prog"):
            np.testing.assert_allclose(g[k], w[k], atol=1.5e-3, err_msg=k)
