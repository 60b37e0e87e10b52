"""One rollout engine split over several devices (``RolloutEngine(...,
devices=[...])``, the port of the JAX engine's ``dp`` mesh) against the
same engine on one device. On the CPU with ``devices=["cpu", "cpu"]`` at
the small widths of ``tests/torch_port_common.py``, B=4: two map-update
steps and an act within 2e-4 (the tolerance of
``tests/test_sharding.py``'s dp test), then ``keep`` to 3 envs (one
chunk: 3 has no divisor that fits 2) and to 2 (two chunks of 1),
``zero_hidden_at`` on an env of the second chunk, and a step after each.
The trainer gives the engine every local card only when it is the one
rank. No JAX."""
import numpy as np
import pytest
import torch

from tests.torch_port_common import INSTR_LEN, port_config, raw_obs, tokens
from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.tools.synthetic import tiny_config
from ws_mgmap_tpu_torch.train import trainer as trainer_mod
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

TOL = dict(rtol=2e-4, atol=2e-4)
B = 4
FIELDS = ("action", "prog", "hidden", "global_map", "ego_map",
          "pred_sem_map", "att_map", "rgb_features", "depth_features",
          "value", "action_log_probs")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, what):
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               err_msg=what, **TOL)


def _engines():
    torch.manual_seed(0)
    policy = BasePolicy(port_config())
    one = RolloutEngine(policy, B, instruction_len=INSTR_LEN, device="cpu")
    split = RolloutEngine(policy, B, instruction_len=INSTR_LEN,
                          devices=["cpu", "cpu"])
    return one, split


def _state(one, split, what):
    _close(split.hidden, one.hidden, what + " hidden")
    _close(split.global_map, one.global_map, what + " global_map")
    assert split.hidden.shape == one.hidden.shape
    np.testing.assert_allclose(split.prog, one.prog, err_msg=what, **TOL)


def test_split_equals_one_engine_through_keep():
    one, split = _engines()
    assert split.chunks == [(0, 2), (2, 4)] and one.chunks == [(0, 4)]
    assert len(split.replicas) == 2 and split.replicas[0] is split.policy
    assert split.replicas[1] is not split.policy
    for p, q in zip(split.replicas[0].parameters(),
                    split.replicas[1].parameters()):
        assert p.data_ptr() != q.data_ptr() and torch.equal(p, q)
    encodes = [0, 0]
    for j, rep in enumerate(split.replicas):
        real = rep.encode_text

        def counted(tok, j=j, real=real):
            encodes[j] += 1
            assert tok.shape[0] == split.chunks[j][1] - split.chunks[j][0]
            return real(tok)
        rep.encode_text = counted

    rng = np.random.RandomState(0)
    instr = tokens(rng, B, [5, 9, 12, INSTR_LEN])
    for t, m in ((0, 0.0), (1, 1.0)):
        batch = one.batch_obs(raw_obs(rng, B, t, instr))
        masks = np.full((B, 1), m, np.float32)
        _close(split.update_map(batch, masks), one.update_map(batch, masks),
               f"ego {t}")
        _state(one, split, f"update_map {t}")
    batch = one.batch_obs(raw_obs(rng, B, 2, instr))
    masks = np.ones((B, 1), np.float32)
    out_s, out_1 = split.act(batch, masks), one.act(batch, masks)
    for f in FIELDS:
        _close(getattr(out_s, f), getattr(out_1, f), f"act {f}")
    _state(one, split, "act")
    assert encodes == [1, 1]
    assert [h.shape[1] for h in split._hidden] == [2, 2]
    with pytest.raises(ValueError, match="batch of 3"):
        split.update_map(one.batch_obs(raw_obs(rng, 3, 3, instr)),
                         masks[:3])

    # 3 envs: one chunk (the fourth env's state moves off chunk 1)
    keep = [0, 1, 3]
    one.keep(keep)
    split.keep(keep)
    assert split.chunks == [(0, 3)] and len(split._global) == 1
    _state(one, split, "keep 3")
    instr = instr[keep]
    batch = one.batch_obs(raw_obs(rng, 3, 3, instr))
    out_s, out_1 = split.act(batch, masks[:3]), one.act(batch, masks[:3])
    for f in FIELDS:
        _close(getattr(out_s, f), getattr(out_1, f), f"act keep 3 {f}")
    assert encodes == [2, 1]

    # 2 envs: two chunks of 1 again; zero the env of the second
    keep = [0, 2]
    one.keep(keep)
    split.keep(keep)
    assert split.chunks == [(0, 1), (1, 2)]
    _state(one, split, "keep 2")
    before = split.hidden.clone()
    one.zero_hidden_at(1)
    split.zero_hidden_at(1)
    assert not split._hidden[1].any() and split.hidden[:, 1].abs().sum() == 0
    assert torch.equal(split.hidden[:, 0], before[:, 0])
    _state(one, split, "zero_hidden_at")
    instr = instr[keep]
    batch = one.batch_obs(raw_obs(rng, 2, 4, instr))
    _close(split.update_map(batch, masks[:2]), one.update_map(batch,
                                                              masks[:2]),
           "ego keep 2")
    out_s, out_1 = split.act(batch, masks[:2]), one.act(batch, masks[:2])
    for f in FIELDS:
        _close(getattr(out_s, f), getattr(out_1, f), f"act keep 2 {f}")
    _state(one, split, "keep 2 act")
    assert encodes == [3, 2]
    split.keep([])
    assert split.num_envs == 0 and split.hidden.shape[1] == 0


def test_uneven_batches_fall_back_to_fewer_chunks():
    torch.manual_seed(0)
    policy = BasePolicy(port_config())
    eng = RolloutEngine(policy, 6, instruction_len=INSTR_LEN,
                        devices=["cpu"] * 4)
    assert eng.chunks == [(0, 2), (2, 4), (4, 6)]      # best_dp(6, 4) = 3
    for n, want in ((5, [(0, 5)]), (4, [(0, 1), (1, 2), (2, 3), (3, 4)]),
                    (1, [(0, 1)]), (0, [(0, 0)])):
        eng.reset_state(n)
        assert eng.chunks == want
        assert [g.shape[0] for g in eng._global] == [b - a for a, b in want]
    eng.global_map = torch.zeros(0, *eng.global_map.shape[1:])
    with pytest.raises(ValueError, match="device or devices"):
        RolloutEngine(policy, 1, device="cpu", devices=["cpu"])


def test_trainer_splits_only_as_the_one_rank(tmp_path, monkeypatch):
    made = []

    class Recorder:
        def __init__(self, policy, num_envs, **kw):
            made.append(kw)

    monkeypatch.setattr(trainer_mod, "RolloutEngine", Recorder)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = tiny_config(str(tmp_path))
    for world, rank in ((1, 0), (2, 1)):
        t = trainer_mod.DaggerTrainer(cfg, rank=rank, world_size=world,
                                      env_workers=False, device="cpu")
        t.device = torch.device("cuda", rank)
        t._engine(None, 6)
    one_rank, two_ranks = made
    assert "device" not in one_rank and one_rank["devices"] == [
        torch.device("cuda", i) for i in range(4)]
    assert "devices" not in two_ranks
    assert two_ranks["device"] == torch.device("cuda", 1)
    t.device = torch.device("cuda", 2)   # the one rank on card 2
    t.world_size = 1
    t._engine(None, 6)
    assert [d.index for d in made[-1]["devices"]] == [2, 0, 1, 3]
    t.device = torch.device("cpu")
    t._engine(None, 6)
    assert "devices" not in made[-1] and made[-1]["device"].type == "cpu"
