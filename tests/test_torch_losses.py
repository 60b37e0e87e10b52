"""The port's losses vs the JAX package's ``train/losses.py`` on seeded
numpy inputs at the full map sizes (a 100^2 GT map against 48^2 logits and
a 24^2 attention grid), fp32 on the CPU. Tolerances per check: 1e-6
relative where only summation order differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.ops import pooling as jpool
from ws_mgmap_tpu.train import losses as jlosses
from ws_mgmap_tpu_torch.ops import pooling
from ws_mgmap_tpu_torch.train import losses

N, T = 2, 3


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("size,out", [(100, 48), (20, 8), (24, 48), (7, 7)])
def test_interpolate_nearest_matches_jax(size, out):
    x = np.random.RandomState(size).randn(2, size, size + 1, 3).astype(
        np.float32)
    want = jpool.interpolate_nearest_nhwc(jnp.asarray(x), (out, out + 1))
    got = pooling.interpolate_nearest_nhwc(_t(x), (out, out + 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,out", [(100, 24), (20, 4), (100, 50), (9, 4)])
def test_interpolate_area_matches_jax(size, out):
    """100 -> 24 and 9 -> 4 take JAX's general adaptive-bin branch, 20 -> 4
    and 100 -> 50 its integer-window one."""
    x = np.random.RandomState(size + out).rand(2, size, size, 2).astype(
        np.float32)
    want = jpool.interpolate_area_nhwc(jnp.asarray(x), (out, out))
    got = pooling.interpolate_area_nhwc(_t(x), (out, out))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_action_loss_matches_jax():
    rng = np.random.RandomState(1)
    mean = rng.randn(N, T, 2).astype(np.float32)
    wp = rng.uniform(-1, 1, (N, T, 2)).astype(np.float32)
    w = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    want = jlosses.action_loss(jnp.asarray(mean), jnp.asarray(wp),
                               jnp.asarray(w))
    got = losses.action_loss(_t(mean), _t(wp), _t(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_prediction_monitor_matches_jax():
    """100 -> 48 nearest targets (not an integer scale)."""
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 48, 48, 27).astype(np.float32) * 2
    gt = rng.randint(0, 27, (4, 100, 100)).astype(np.int32)
    want = jlosses.prediction_monitor(jnp.asarray(logits), jnp.asarray(gt))
    got = losses.prediction_monitor(_t(logits), _t(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_contrastive_monitor_matches_jax():
    """The 100 -> 24 area resample and the whole-batch max/min: one
    sample's distance map changes another's loss."""
    rng = np.random.RandomState(3)
    att = _softmax(rng.randn(3, 576) * 3)
    att[0, :10] = 0.0  # log(max(att, 1e-30))
    dis = (rng.rand(3, 100, 100) * 30).astype(np.float32)
    want = jlosses.contrastive_monitor(jnp.asarray(att), jnp.asarray(dis),
                                       0.07)
    got = losses.contrastive_monitor(_t(att), _t(dis), 0.07)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    dis2 = dis.copy()
    dis2[2] *= 3.0
    moved = losses.contrastive_monitor(_t(att), _t(dis2), 0.07)
    np.testing.assert_allclose(
        moved.numpy(),
        np.asarray(jlosses.contrastive_monitor(jnp.asarray(att),
                                               jnp.asarray(dis2), 0.07)),
        rtol=1e-5)
    assert not np.isclose(float(moved[0]), float(got[0]), rtol=1e-3)


def test_progress_monitor_matches_jax():
    rng = np.random.RandomState(4)
    prog = np.tanh(rng.randn(6, 1)).astype(np.float32)
    tgt = rng.rand(6, 1).astype(np.float32)
    want = jlosses.progress_monitor(jnp.asarray(prog), jnp.asarray(tgt))
    got = losses.progress_monitor(_t(prog), _t(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _loss_inputs(rng):
    pred = rng.randn(N, T, 2).astype(np.float32)
    aux = {"pred_sem_map": rng.randn(N, T, 48, 48, 27).astype(np.float32),
           "att_map": _softmax(rng.randn(N, T, 576)),
           "prog": np.tanh(rng.randn(N, T, 1)).astype(np.float32)}
    batch = {"waypoint": rng.uniform(-1, 1, (N, T, 2)).astype(np.float32),
             "gt_semantic_map": rng.randint(0, 27, (N, T, 100, 100)).astype(
                 np.int32),
             "gt_path": (rng.rand(N, T, 100, 100) * 20).astype(np.float32),
             "progress": rng.rand(N, T, 1).astype(np.float32)}
    weights = np.array([[1, 1, 1], [1, 0, 0]], np.float32)
    return pred, aux, batch, weights


@pytest.mark.parametrize("mon,drop", [
    (dict(), None),
    (dict(contrastive=False, prediction_alpha=0.5), None),
    (dict(), "progress"),
    (dict(progress=False, contrastive=False, prediction=False), None),
])
def test_total_loss_matches_jax(mon, drop):
    """total_loss and its metrics (names and values), with monitors off and
    a missing target."""
    pred, aux, batch, weights = _loss_inputs(np.random.RandomState(5))
    if drop:
        del batch[drop]
    want_loss, want = jlosses.total_loss(
        jnp.asarray(pred), {k: jnp.asarray(v) for k, v in aux.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(weights),
        jlosses.MonitorConfig(**mon))
    loss, got = losses.total_loss(
        _t(pred), {k: _t(v) for k, v in aux.items()},
        {k: _t(v) for k, v in batch.items()}, _t(weights),
        losses.MonitorConfig(**mon))
    assert set(got) == set(want)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_reduce_aux_sums_in_key_order():
    """The sum runs in sorted key order, whatever the dict's order, as
    JAX's does: both orders give the same bits."""
    rng = np.random.RandomState(6)
    vecs = {k: rng.randn(5).astype(np.float32) * 10 ** e
            for e, k in zip((6, -3, 0), ("b", "a", "c"))}
    mask = np.array([1, 1, 0, 1, 1], bool)
    want = jlosses.reduce_aux(
        {k: (jnp.asarray(v), 0.3) for k, v in vecs.items()},
        jnp.asarray(mask))
    got = [float(losses.reduce_aux({k: (_t(vecs[k]), 0.3) for k in order},
                                   _t(mask)))
           for order in (("b", "a", "c"), ("c", "b", "a"), ("a", "b", "c"))]
    assert got[0] == got[1] == got[2]
    np.testing.assert_allclose(got[0], float(want), rtol=1e-6)
