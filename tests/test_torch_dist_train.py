"""The port's data-parallel update: N gloo ranks, each fed its shard of a
store through the port's ``ReplayLoader`` (``fixed_len``, as the trainer
runs more than one rank), against one process updating on the global
batch (every rank's batch, concatenated in rank order).

The ranks run in subprocesses of the JAX-free worker
``ws_mgmap_tpu_torch/tools/dist_train_check.py`` (rendezvous through a file
store, a deadline on every launch), at the small widths of
``tests/torch_port_common.py``, from seeded weights with non-trivial
BatchNorm statistics. In float64 the ranks hold the one process to
rounding: loss and metrics 1e-9 relative, BN statistics 1e-9, gradients
1e-7 relative L2, post-Adam parameters 1e-8; the ranks' parameters are
bit-identical. In fp32 the JAX package's data-parallel rule applies
(``tests/test_train_step.py``): loss 2e-5 relative, gradients 3e-2
relative L2.
"""
import json

import numpy as np
import pytest
import torch

from tests.torch_port_common import MAP, SMALL, port_config, train_episodes
from ws_mgmap_tpu_torch.data.trajstore import TrajStoreWriter, pack_record
from ws_mgmap_tpu_torch.models.layers import (BatchNorm2d, bn_stats_frozen,
                                              global_batch_stats)
from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.parallel import mesh
from ws_mgmap_tpu_torch.tools import dist_train_check as dtc
from ws_mgmap_tpu_torch.train import step
from ws_mgmap_tpu_torch.train.losses import MonitorConfig

LENGTHS = (5, 3, 4, 6)  # four episodes; fixed_len pads each rank to 6
LAUNCH_TIMEOUT_S = 240


def seeded_weights(seed: int = 0) -> dict:
    """The small policy, torch's init from ``seed``, with non-trivial BN
    statistics and affines."""
    torch.manual_seed(seed)
    policy = BasePolicy(port_config())
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in policy.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return policy.state_dict()


def write_store(directory, lengths, seed=9):
    eps = train_episodes(np.random.RandomState(seed), lengths)
    w = TrajStoreWriter(str(directory))
    w.append_batch([pack_record(e) for e in eps])
    w.close()


def make_run_dir(directory, world, runs, weights):
    """A worker directory: the weights, the store, the spec."""
    directory.mkdir()
    torch.save(weights, directory / "weights.pt")
    write_store(directory / "store", LENGTHS)
    spec = dict(weights="weights.pt", config=SMALL, mapper=MAP, device="cpu",
                threads=1, timeout_s=120,
                runs=[dict(store="store", batch_size=len(LENGTHS) // world,
                           max_len=max(LENGTHS), **r) for r in runs])
    (directory / "spec.json").write_text(json.dumps(spec))
    return spec


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's in-process updates on one CPU thread, as its ranks
    run: the updates are small, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = dict(dtype="float64", remat=False)
F64_REMAT = dict(dtype="float64", remat=True)
F32 = dict(dtype="float32", remat=False)


def launched(tmp_path_factory, world, runs):
    """(every rank's results, the one process's) for ``runs``."""
    d = tmp_path_factory.mktemp(f"dp{world}") / "run"
    spec = make_run_dir(d, world, runs, seeded_weights())
    dtc.launch_ranks(world, d, LAUNCH_TIMEOUT_S)
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(world)]
    single = dtc.run_updates(spec, d, None, world, torch.device("cpu"))
    return ranks, single


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return launched(tmp_path_factory, 2, [F64, F64_REMAT, F32])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return launched(tmp_path_factory, 4, [F64])


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def assert_update_matches(got, want, loss_rtol, grad_rtol, stat_tol,
                          param_atol):
    """One update's results against another's: metrics, gradients (a
    tensor whose reference norm is below 1e-5 is a degenerate direction,
    a conv bias feeding train-mode BN: both sides are rounding), BN
    statistics, parameters."""
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=loss_rtol,
                                   err_msg=k)
    assert got["grads"].keys() == want["grads"].keys()
    worst, checked = 0.0, 0
    for k, g in want["grads"].items():
        if float(g.norm()) < 1e-5:
            assert float(got["grads"][k].norm()) < 1e-4, k
            continue
        worst = max(worst, _rel_l2(got["grads"][k], g))
        checked += 1
    assert checked > 60 and worst < grad_rtol, worst
    stats = [k for k in want["state"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert len(stats) > 20
    for k in stats:
        torch.testing.assert_close(got["state"][k], want["state"][k],
                                   rtol=stat_tol, atol=stat_tol, msg=k)
    for k in want["grads"]:
        torch.testing.assert_close(got["state"][k], want["state"][k],
                                   rtol=0, atol=param_atol, msg=k)


def assert_ranks_identical(ranks, run):
    for r in ranks[1:]:
        assert r[run]["metrics"] == ranks[0][run]["metrics"]
        for k, v in ranks[0][run]["state"].items():
            assert torch.equal(r[run]["state"][k], v), k


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_one_process_f64(request, world):
    """float64: N ranks == one process on the global batch (measured
    worst: gradients 6.5e-15 relative L2, state 2.1e-13)."""
    ranks, single = request.getfixturevalue(
        {2: "two_ranks", 4: "four_ranks"}[world])
    assert (ranks[0][0]["N"], ranks[0][0]["T"]) == (4 // world, 6)
    assert (single[0]["N"], single[0]["T"]) == (4, 6)
    for r in ranks:
        assert_update_matches(r[0], single[0], 1e-9, 1e-7, 1e-9, 1e-8)
    assert_ranks_identical(ranks, 0)


def test_remat_matches_plain_on_two_ranks(two_ranks):
    """remat on 2 ranks: the recompute issues the BN all-reduces again in
    the backward (under bn_stats_frozen: the statistics move once) and
    the update is the plain one's."""
    ranks, _ = two_ranks
    for r in ranks:
        assert_update_matches(r[1], r[0], 1e-12, 1e-10, 1e-12, 1e-12)
        nbt = {k: int(v) for k, v in r[1]["state"].items()
               if k.endswith("num_batches_tracked")}
        assert {n for k, n in nbt.items()
                if not k.startswith("net.rgb_encoder.")} == {1}
    assert_ranks_identical(ranks, 1)


def test_ranks_match_one_process_fp32(two_ranks):
    """fp32, 2 ranks against one process, by the JAX package's rule for
    its 1- vs 8-device update (measured worst: 5.3e-6 relative L2)."""
    ranks, single = two_ranks
    for r in ranks:
        for k, v in single[2]["metrics"].items():
            np.testing.assert_allclose(r[2]["metrics"][k], v, rtol=2e-5,
                                       err_msg=k)
        worst = max(_rel_l2(r[2]["grads"][k], g)
                    for k, g in single[2]["grads"].items()
                    if float(g.norm()) >= 1e-5)
        assert worst < 3e-2, worst
    assert_ranks_identical(ranks, 2)


def test_collectives_per_update(two_ranks):
    """Per update: 2 all-reduces per train-mode BN layer (forward and
    backward; remat adds the recompute's forward), the losses' 3 and the
    gradient bucket, the trainable parameters with a gradient; no kernel
    launch."""
    ranks, single = two_ranks
    policy = BasePolicy(port_config())
    policy.train()
    n_bn = sum(isinstance(m, BatchNorm2d) and m.training
               for m in policy.modules())
    assert n_bn == 16
    for r in ranks:
        plain, remat, fp32 = r
        assert plain["allreduces"] == fp32["allreduces"] == 2 * n_bn + 3 + 1
        assert remat["allreduces"] == 3 * n_bn + 3 + 1
        n_grad = sum(g.numel() for g in plain["grads"].values())
        assert plain["bucket_bytes"] == 8 * n_grad == 2 * fp32["bucket_bytes"]
        assert plain["allreduce_bytes"][-1] == plain["bucket_bytes"]
        for run in r:
            assert run["launches"] == {"splat_max": 0, "conv_wgmma": 0,
                                       "conv_direct": 0}
    assert single[0]["allreduces"] == 0


def test_launch_kills_ranks_at_the_deadline(tmp_path):
    """A rank that does not finish in time fails the launch (and is
    killed) instead of hanging the caller."""
    d = tmp_path / "run"
    make_run_dir(d, 2, [F64], seeded_weights())
    with pytest.raises(RuntimeError, match="did not finish in 1.0 s"):
        dtc.launch_ranks(2, d, 1.0)


def test_init_distributed_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: init_distributed() would join NCCL")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_distributed()
    with pytest.raises(RuntimeError, match="needs a process group"):
        step.make_train_step(MonitorConfig(), distributed=True)


def test_shard_batch_and_best_dp():
    batch = {"obs": {"x": np.arange(12).reshape(6, 2)},
             "weights": torch.arange(6)}
    parts = [mesh.shard_batch(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(parts[1]["obs"]["x"], [[4, 5], [6, 7]])
    assert parts[2]["weights"].tolist() == [4, 5]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, 0, 4)
    assert [mesh.best_dp(b, 4) for b in (5, 6, 8, 3)] == [1, 3, 4, 3]
    assert mesh.dp_size() == 1 and mesh.best_dp(6) == 1


def _update(weights, batch, distributed=False):
    policy = BasePolicy(port_config())
    policy.load_state_dict(weights)
    state = step.create_train_state(policy.double(), device="cpu")
    metrics = step.make_train_step(MonitorConfig(),
                                   distributed=distributed)(state, batch)
    return metrics, state.policy


def test_default_path_ignores_a_group(tmp_path, monkeypatch):
    """The plain update is bit for bit the same with a process group up
    as without one; the distributed update of a one-rank group equals it
    to float64 rounding."""
    d = tmp_path / "one"
    make_run_dir(d, 1, [F64], seeded_weights(1))
    run = dtc.load_spec(d)["runs"][0]
    batch = dtc.cast_batch(dtc.rank_batch(run, d, 0, 1), torch.float64)
    weights = torch.load(d / "weights.pt")
    want, want_policy = _update(weights, batch)
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    mesh.init_distributed(device="cpu",
                          init_method=f"file://{tmp_path / 'rendezvous'}",
                          timeout_s=60)
    try:
        assert mesh.group_active() and mesh.dp_size() == 1
        got, got_policy = _update(weights, batch)
        dp, dp_policy = _update(weights, batch, distributed=True)
    finally:
        torch.distributed.destroy_process_group()
    assert not mesh.group_active()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        np.testing.assert_allclose(float(dp[k]), float(v), rtol=1e-12)
    for (k, v), g, p in zip(want_policy.state_dict().items(),
                            got_policy.state_dict().values(),
                            dp_policy.state_dict().values()):
        assert torch.equal(g, v), k
        torch.testing.assert_close(p, v, rtol=1e-10, atol=1e-12, msg=k)


def test_global_bn_without_a_group():
    """The global train-mode path of one process: flax's statistics from
    the sums, the output and the running statistics of the plain path to
    float64 rounding, and none moved under bn_stats_frozen."""
    x = torch.from_numpy(np.random.RandomState(6).randn(3, 4, 5, 5) * 2 + 1)
    bn = BatchNorm2d(4).double().train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.2, 0.2)
    ref = BatchNorm2d(4).double().train()
    ref.load_state_dict(bn.state_dict())
    want = ref(x)
    with global_batch_stats(bn):
        got = bn(x)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        for k, v in ref.state_dict().items():
            torch.testing.assert_close(bn.state_dict()[k], v, rtol=1e-12,
                                       atol=1e-14)
        before = {k: v.clone() for k, v in bn.state_dict().items()}
        with bn_stats_frozen(bn):
            bn(x)
        for k, v in before.items():
            assert torch.equal(bn.state_dict()[k], v), k
    assert not bn.global_stats


def test_pipeline_two_ranks(tmp_path):
    """``pipeline``: the whole ``DaggerTrainer.train()`` on two gloo ranks
    (the JAX check's mode): each rank collects its dataset shard into its
    own store shard, both update together (the same global metrics on
    each), rank 0 alone writes the checkpoint; no kernel launches on the
    CPU."""
    from ws_mgmap_tpu_torch.data.trajstore import TrajStoreReader

    d = tmp_path / "pipeline"
    d.mkdir()
    (d / "spec.json").write_text(json.dumps({
        "device": "cpu", "backend": None, "threads": 1,
        "timeout_s": LAUNCH_TIMEOUT_S,
        "opts": ["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "30",
                 "ep_max_len", "30"]}))
    dtc.launch_ranks(2, d, LAUNCH_TIMEOUT_S, mode="pipeline")
    done = [json.loads((d / f"rank{r}_done.json").read_text())
            for r in (0, 1)]
    assert done[0]["metrics"] == done[1]["metrics"]
    assert np.isfinite(done[0]["metrics"]["loss"])
    assert all(r["launches"] == {"splat_max": 0, "conv_wgmma": 0,
                                 "conv_direct": 0} for r in done)
    assert sorted(p.name for p in (d / "traj").glob("shard_*.idx")) == [
        "shard_0.idx", "shard_1.idx"]
    r = TrajStoreReader(str(d / "traj"))
    assert len(r) >= 2
    r.close()
    assert sorted(p.name for p in (d / "ckpt").iterdir()) == ["ckpt.0.pth"]
