"""The plain reference against the port on the CPU at a small size: one
``act``, one ``update_map`` and one teacher-forcing update from the same
weights and inputs. This file imports both; the reference imports
nothing of the port."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import system
from benchmark.drivers import rollout as R
from benchmark.drivers import train as T
from benchmark.reference import policy as ref_policy
from benchmark.reference import train as ref_train
from benchmark.reference.precision import arithmetic
from benchmark.tests import tiny
from benchmark.traffic.episodes import RolloutEpisodes, replay_episodes
from benchmark.traffic.rooms import FramePool

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


@pytest.fixture(scope="module", params=["fp32_rollout_b5", "bf16_rollout_b5"])
def rollout_case(request):
    """One engine (in fp32 whatever the cell, so that both sides compute
    alike) after a few steps, the pool, the weights and a step's
    inputs."""
    workload, cfg = tiny.cell(request.param)
    cfg = dict(cfg, rollout_dtype="fp32")
    t = workload["traffic"]
    torch.set_num_threads(2)
    sd = system.weights(cfg, SEED, CPU)
    engine = system.engine(cfg, system.build_policy(cfg, sd, CPU), 2, CPU)
    pool = FramePool(SEED, 2, 1, t["episode_steps"][1], t, cfg["rgb_hw"],
                     cfg["depth_hw"], CPU)
    eps = [RolloutEpisodes(SEED, i, t, cfg["vocab_size"],
                           cfg["instruction_len"]) for i in range(2)]
    loop = R.Collect(engine, pool, eps, {})
    for _ in range(4):   # the map and the hidden state hold something
        loop.step()
    return cfg, sd, loop, pool


@pytest.mark.parametrize("kind", ["act", "update_map"])
def test_rollout_step_matches(rollout_case, kind):
    cfg, sd, loop, pool = rollout_case
    while (loop.count_step % 3 == 0) != (kind == "act"):
        loop.step()
    sample: dict = {}
    loop.step(sample)
    with arithmetic("fp32"):
        ref = R.reference_step(sd, cfg, sample, pool, CPU)
    got = sample["out"]
    assert set(got) <= set(ref)
    for k in got:
        num, den = R.rel_terms(got[k], ref[k])
        assert num <= 1e-8 * den, k
    assert float(ref["global_map"].abs().sum()) > 0


def test_reference_text_encoder_matches_the_port():
    workload, cfg = tiny.cell("fp32_rollout_b5")
    sd = system.weights(cfg, SEED, CPU)
    policy = system.build_policy(cfg, sd, CPU)
    tokens = torch.zeros(3, 20, dtype=torch.int32)
    tokens[0, :20] = torch.arange(1, 21)
    tokens[1, :5] = torch.arange(7, 12)   # row 2 stays all pads
    with torch.no_grad():
        want, want_pad = policy.encode_text(tokens)
        got, got_pad = ref_policy.encode_text(sd, tokens)
    assert torch.equal(want_pad, got_pad)
    assert float((got - want).abs().max()) < 1e-6


def test_update_matches():
    workload, cfg = tiny.cell("fp32_train_n8")
    t = dict(workload["traffic"], followed=1)
    torch.set_num_threads(2)
    from ws_mgmap_tpu_torch.train import step as step_mod
    from ws_mgmap_tpu_torch.train.losses import MonitorConfig
    from ws_mgmap_tpu_torch.train.replay import collate_episodes

    sd = system.weights(cfg, SEED, CPU)
    episodes = replay_episodes(SEED, t, cfg, CPU)
    batch = ref_train.collate(episodes[:2], t["max_len"])
    port_batch = collate_episodes(sorted(episodes[:2], key=lambda e: e[
        "prev_actions"].shape[0]), t["max_len"])
    for k in batch["obs"]:
        assert np.array_equal(batch["obs"][k], port_batch["obs"][k])
    state = step_mod.create_train_state(system.build_policy(cfg, sd, CPU),
                                        cfg["lr"], device="cpu")
    update = step_mod.make_train_step(MonitorConfig(**T.monitors(cfg)))
    start = {n: p.detach().clone() for n, p in
             state.policy.named_parameters() if p.requires_grad}
    loss = float(update(state, port_batch)["loss"])
    with arithmetic("fp32"):
        ref = ref_train.follow(sd, cfg, [batch], cfg["lr"], T.monitors(cfg),
                               CPU)
    assert abs(loss - ref["losses"][0]) <= 1e-5 * abs(ref["losses"][0])
    opt = state.optimizer.state
    # a leaf's gap against its own norm or the median leaf's, as judged
    median = float(np.median([v for v in ref["first_grad"].values()
                              if v is not None]))
    moved = 0
    for n, p in state.policy.named_parameters():
        if not p.requires_grad:
            continue
        g_ref = ref["first_grad"][n]
        if p not in opt:
            assert g_ref is None, n
            continue
        g = float(opt[p]["exp_avg"].norm()) / (1 - T.ADAM_B1)
        assert abs(g - g_ref) <= 1e-4 * max(g_ref, median), n
        moved += float((p.detach() - start[n]).norm()) > 0
    assert moved > 10
