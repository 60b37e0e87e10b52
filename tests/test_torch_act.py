"""The slice as a whole: the port's ``RolloutEngine`` vs the JAX package's
over an episode at the reference cadence (act, update_map, update_map):
``masks=0`` at the start and for env 0 at the second act, where env 0
also gets a new instruction (the text cache re-encodes), one
``zero_hidden_at``, and one ``keep()`` that drops an env before a third
act (the cache re-encodes again). Small widths
(``tests/torch_port_common.py``), weights from ``from_jax_variables``.

fp32 parity mode: every output of every step against JAX at the
tolerances stated below. bf16 + rotate-in-splat with fused mode "on" in
both packages (JAX: Pallas in interpret mode; the port: its kernel
wrappers, which run their twins on CPU tensors): the waypoint and the
progress as the JAX package holds bf16 against fp32
(``tests/test_bf16_rollout.py``: atol 0.12 after tanh), the value,
hidden state, attention weights and semantic logits at twice the worst
error measured against JAX's bf16 engine, the maps as
``tests/test_torch_update_map.py`` holds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import (SMALL, init_policy_variables,
                                     jax_config, port_policy, raw_obs,
                                     tokens)
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.ops.pallas import conv as jconv
from ws_mgmap_tpu.train.rollout import RolloutEngine as JEngine
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

B = 3
ACT_FIELDS = ("value", "action", "action_log_probs", "hidden", "prog",
              "pred_sem_map", "att_map", "ego_map", "global_map",
              "rgb_features", "depth_features")


@pytest.fixture(scope="module")
def weights():
    return init_policy_variables(1)


def _episode():
    """(kind, raw obs, masks) per step, and where the engines change:
    ``zero_hidden_at(1)`` after step 3, ``keep([0, 2])`` before step 6."""
    rng = np.random.RandomState(41)
    instr = tokens(rng, B, (9, 24, 4))
    steps = []
    for t in range(7):
        masks = np.ones((B, 1), np.float32)
        if t == 0:
            masks[:] = 0.0
        if t == 3:  # env 0 starts a new episode with a new instruction
            masks[0] = 0.0
            instr = instr.copy()
            instr[0] = tokens(rng, 1, (16,))[0]
        kind = "act" if t % 3 == 0 else "update_map"
        steps.append((kind, raw_obs(rng, B, t, instr), masks))
    return steps


def _run(weights, bf16: bool):
    """Both engines through the episode; per step the pair of outputs as
    numpy (acts: every field and the engine's prog; update_map: the ego
    and global maps), and the number of text encodes of each."""
    jeng = JEngine(JPolicy(jax_config(rotate=bf16)), weights, B,
                   instruction_len=24,
                   compute_dtype=jnp.bfloat16 if bf16 else None)
    teng = RolloutEngine(port_policy(weights, rotate=bf16), B,
                         instruction_len=24, device="cpu",
                         compute_dtype=torch.bfloat16 if bf16 else None)
    encodes = {"jax": 0, "port": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            encodes[name] += 1
            return fn(*a, **k)
        return wrapped

    jeng._encode_text = counted("jax", jeng._encode_text)
    teng.policy.encode_text = counted("port", teng.policy.encode_text)
    if bf16:
        jconv.set_fused_conv_mode("on")
        kconv.set_fused_conv_mode("on")
    out = []
    try:
        for t, (kind, raw, masks) in enumerate(_episode()):
            if t == 6:
                jeng.keep([0, 2])
                teng.keep([0, 2])
                raw, masks = [raw[0], raw[2]], masks[[0, 2]]
            if kind == "act":
                jo = jeng.act(jeng.batch_obs(raw), masks)
                to = teng.act(teng.batch_obs(raw), masks)
                assert to.action.dtype == torch.float32
                assert teng.hidden.dtype == teng.dtype
                pair = {f: (np.asarray(getattr(jo, f), np.float32),
                            getattr(to, f).float().numpy().copy())
                        for f in ACT_FIELDS}
                pair["engine.prog"] = (np.asarray(jeng.prog), teng.prog)
            else:
                jego = jeng.update_map(jeng.batch_obs(raw), masks)
                ego = teng.update_map(teng.batch_obs(raw), masks)
                pair = {"ego_map": (np.asarray(jego, np.float32),
                                    ego.numpy()),
                        "global_map": (np.asarray(jeng.global_map,
                                                  np.float32),
                                       teng.global_map.float().numpy()
                                       .copy())}
            if t == 3:
                jeng.zero_hidden_at(1)
                teng.zero_hidden_at(1)
                pair["hidden_zeroed"] = (np.asarray(jeng.hidden, np.float32),
                                         teng.hidden.float().numpy())
            out.append((kind, pair))
    finally:
        jconv.set_fused_conv_mode("auto")
        kconv.set_fused_conv_mode("auto")
    return out, encodes


def test_engine_episode_fp32_parity_mode(weights):
    steps, encodes = _run(weights, bf16=False)
    assert encodes == {"jax": 3, "port": 3}  # t0, the new instruction, keep
    assert [k for k, _ in steps] == ["act", "update_map", "update_map"] * 2 \
        + ["act"]
    for t, (kind, pair) in enumerate(steps):
        for name, (want, got) in pair.items():
            assert got.shape == want.shape, (t, name)
            # measured worst over the episode: 8.5e-7 abs on the heads,
            # hidden state and logits, 1.1e-8 on the attention weights,
            # 7.6e-6 of the range on the maps and the trunks' features
            if name in ("ego_map", "global_map", "rgb_features",
                        "depth_features"):
                atol, rtol = 2e-5 * float(np.abs(want).max()), 0.0
            elif name == "att_map":
                atol, rtol = 1e-7, 1e-5
            else:
                atol, rtol = 2e-5, 1e-5
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"step {t} {name}")
    hid_j, hid_t = steps[3][1]["hidden_zeroed"]
    assert not hid_t[:, 1].any() and hid_t[:, [0, 2]].any()
    assert not hid_j[:, 1].any()
    assert steps[6][1]["hidden"][1].shape == (2, 2, SMALL["hidden_size"])


def test_engine_episode_bf16_rotate_in_splat(weights):
    steps, encodes = _run(weights, bf16=True)
    assert encodes == {"jax": 3, "port": 3}
    for t, (kind, pair) in enumerate(steps):
        if kind == "act":
            # measured worst: 2.3e-3 on tanh(action), 2.1e-3 on prog
            (ja, ta), (jp, tp) = pair["action"], pair["prog"]
            np.testing.assert_allclose(np.tanh(ta), np.tanh(ja), atol=0.12,
                                       err_msg=f"step {t} action")
            np.testing.assert_allclose(tp, jp, atol=0.12,
                                       err_msg=f"step {t} prog")
            # against JAX's bf16 engine at twice the measured worst (abs):
            # 1.5e-3 on value, 1.8e-2 on hidden (range 0.93), 4.9e-4 on
            # the attention weights, 3.9e-3 on the semantic logits
            for name, atol in (("value", 3e-3), ("hidden", 3.6e-2),
                               ("att_map", 1e-3), ("pred_sem_map", 8e-3)):
                want, got = pair[name]
                np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                           err_msg=f"step {t} {name}")
        (jego, ego), (jglob, glob) = pair["ego_map"], pair["global_map"]
        # exact binning: the same global support; the ego read-back
        # rounds differently near zero (see test_torch_update_map.py)
        np.testing.assert_array_equal(glob.any(-1), jglob.any(-1))
        assert (ego.any(-1) == jego.any(-1)).mean() >= 0.99, t
        for got, want in ((ego, jego), (glob, jglob)):
            err = np.abs(got - want)
            assert err.max() <= 2e-2 * float(np.abs(want).max()), t
            assert err.mean() <= 1e-2 * float(np.abs(want).mean()), t
    _, hid_t = steps[3][1]["hidden_zeroed"]
    assert not hid_t[:, 1].any()
