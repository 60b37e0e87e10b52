"""The port's teacher-forcing update vs the JAX package's ``make_train_step``
at small widths (``tests/torch_port_common.py``), in fp32 on the CPU.

One batch of three padded episodes (lengths 5, 3, 4: T = 5 with
``t_bucket=1``) from the card drives' own generator, collated by the
port's ``collate_episodes``; the same JAX weights, with non-trivial BN
statistics, in both packages. Tolerances are stated per check; each sits
well above the worst error measured here and at or below the bounds the
port is held to (loss and metrics 1e-5 relative, gradients 1e-3 relative
L2, BN statistics 1e-5). Gradients and post-Adam parameters are held in
float64 (see ``jax_update``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests.torch_port_common import (SMALL, init_policy_variables, jax_batch,
                                     jax_config, port_policy, train_episodes)
from ws_mgmap_tpu.models import rnn as jrnn
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.train import losses as jlosses
from ws_mgmap_tpu.train import step as jstep
from ws_mgmap_tpu.utils.convert import export_torch_state
from ws_mgmap_tpu_torch.models import rnn
from ws_mgmap_tpu_torch.models.layers import BatchNorm2d
from ws_mgmap_tpu_torch.train import replay, step
from ws_mgmap_tpu_torch.train.losses import MonitorConfig

H = SMALL["hidden_size"]
LENGTHS = (5, 3, 4)


@pytest.fixture(scope="module")
def weights():
    return init_policy_variables(3)


@pytest.fixture(scope="module")
def batch():
    return replay.collate_episodes(
        train_episodes(np.random.RandomState(21), LENGTHS), t_bucket=1)


def _port_state(weights, device="cpu"):
    return step.create_train_state(port_policy(weights), device=device)


def _torch_tree(variables, policy):
    """JAX variables (params, batch_stats or grads) as torch-keyed numpy."""
    shapes = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
    return export_torch_state(variables, reference_shapes=shapes)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def jax_update(weights, batch):
    """JAX's ``make_train_step`` on the batch in fp32 (new variables and
    metrics), and in float64 (new variables, and the gradient), all
    torch-keyed numpy. In fp32 the train-mode BN of this batch rounds
    gradients by up to 1.2e-2 relative L2 (the port's fp32 gradient
    against its float64 one), so gradients and post-Adam parameters are
    held in float64, where the packages' gradients agree to 6.6e-7 (the
    contrastive target is fp32 in both): what tells a port fault from
    rounding."""
    policy = JPolicy(jax_config())
    opt = jstep.make_optimizer(2.5e-4)
    update = jstep.make_train_step(policy, opt, jlosses.MonitorConfig(), H)
    template = port_policy(weights)
    out = {}
    for name, v, jb in (("fp32", weights, batch),
                        ("fp64", _f64(weights), _f64(batch))):
        with jax.enable_x64(name == "fp64"):
            v, jb = jax.tree.map(jnp.asarray, (v, jb))
            state = jstep.create_train_state(v, opt)
            new_state, metrics = jax.jit(update)(state, jb)

            def loss_fn(params):
                (pred, aux), _ = policy.apply(
                    {"params": params, "batch_stats": v["batch_stats"]},
                    jb["obs"], jnp.zeros((2, len(LENGTHS), H)),
                    jb["not_done_masks"], True, method=JPolicy.forward_seq,
                    mutable=["batch_stats"])
                return jlosses.total_loss(pred, aux, jb["obs"], jb["weights"],
                                          jlosses.MonitorConfig())[0]

            grads = (jax.jit(jax.grad(loss_fn))(v["params"])
                     if name == "fp64" else {})
            out[name] = (
                _torch_tree(jax.device_get({
                    "params": new_state.params,
                    "batch_stats": new_state.batch_stats}), template),
                {k: float(m) for k, m in metrics.items()},
                _torch_tree({"params": jax.device_get(grads)}, template))
    return out


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_forward_seq_train_mode_matches_jax(weights, batch):
    """forward_seq in train mode: the outputs and the new BN statistics."""
    jb = jax_batch(batch)
    h0 = np.random.RandomState(4).randn(2, len(LENGTHS), H).astype(
        np.float32) * 0.5
    (want_mean, want_aux), mut = jax.jit(lambda v, o, h, m: JPolicy(
        jax_config()).apply(v, o, h, m, True, method=JPolicy.forward_seq,
                            mutable=["batch_stats"]))(
        weights, jb["obs"], jnp.asarray(h0), jb["not_done_masks"])
    policy = port_policy(weights).train()
    obs = step.upload_batch(batch, torch.device("cpu"))["obs"]
    with torch.no_grad():
        mean, aux = policy.forward_seq(obs, torch.from_numpy(h0),
                                       torch.from_numpy(
                                           batch["not_done_masks"]))
    # measured worst (abs): 6e-8 on the features, the mean and prog; on
    # the semantic logits 5.8e-6 of their range (BatchNorm over a 1x1 map
    # of 15 frames in the decoder, whose variance flax takes as E[x^2] -
    # E[x]^2, amplifies rounding)
    np.testing.assert_allclose(mean.numpy(), want_mean, atol=1e-6, rtol=1e-5)
    for k in ("features", "prog"):
        np.testing.assert_allclose(aux[k].numpy(), want_aux[k], atol=1e-6,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(
        aux["pred_sem_map"].numpy(), want_aux["pred_sem_map"],
        atol=1e-4 * float(np.abs(want_aux["pred_sem_map"]).max()), rtol=0)
    np.testing.assert_allclose(aux["att_map"].numpy(), want_aux["att_map"],
                               atol=1e-7, rtol=1e-5)
    want_bs = _torch_tree({"batch_stats": mut["batch_stats"]}, policy)
    got = policy.state_dict()
    assert len(want_bs) == sum(k.endswith(("running_mean", "running_var"))
                               for k in got)
    for k, v in want_bs.items():  # measured worst: 4.3e-7 of the range
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    # the UNet stays in eval mode under policy.train(), as JAX runs it
    assert not any(m.training for m in policy.net.rgb_encoder.modules())
    assert policy.net.map_encoder.training


def test_seq_matches_stepwise(weights, batch):
    """The port's seq == its stepwise decision core, eval mode, with a
    mid-episode reset."""
    policy = port_policy(weights).eval()
    obs = step.upload_batch(batch, torch.device("cpu"))["obs"]
    masks = torch.from_numpy(batch["not_done_masks"]).clone()
    masks[1, 2] = 0.0
    h0 = torch.zeros(2, len(LENGTHS), H)
    with torch.no_grad():
        feats, pred_sem, att = policy.net.seq(obs, h0, masks)
        h, outs = h0, []
        for t in range(masks.shape[1]):
            f, h, ps, a, _, _ = policy.net(
                {k: v[:, t] for k, v in obs.items()}, h, masks[:, t:t + 1])
            outs.append((f, ps, a))
    np.testing.assert_allclose(feats.numpy(),
                               torch.stack([o[0] for o in outs], 1).numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(pred_sem.numpy(),
                               torch.stack([o[1] for o in outs], 1).numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(att.numpy(),
                               torch.stack([o[2] for o in outs], 1).numpy(),
                               atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("cls", ["TorchGRU", "RNNStateEncoder"])
def test_gru_seq_matches_jax(cls):
    """The masked scan over time, a reset (mask 0) mid-sequence included;
    habitat's ``RNNStateEncoder`` keeps the GRU under ``rnn``."""
    rng = np.random.RandomState(5)
    t, b, i, h = 6, 3, 10, 8
    xs = rng.randn(t, b, i).astype(np.float32)
    h0 = rng.randn(b, h).astype(np.float32)
    masks = (rng.rand(t, b, 1) > 0.3).astype(np.float32)
    jmod = getattr(jrnn, cls)(i, h)
    params = jmod.init(jax.random.PRNGKey(0), xs, h0, masks,
                       method=type(jmod).seq)
    want_ys, want_h = jmod.apply(params, xs, h0, masks,
                                 method=type(jmod).seq)
    mod = getattr(rnn, cls)(i, h)
    mod.load_state_dict({
        ".".join(path): torch.tensor(np.asarray(v)) for path, v in
        traverse_util.flatten_dict(params["params"]).items()})
    ys, h_t = mod.seq(torch.from_numpy(xs), torch.from_numpy(h0),
                      torch.from_numpy(masks))
    np.testing.assert_allclose(ys.detach().numpy(), want_ys, atol=1e-6)
    np.testing.assert_allclose(h_t.detach().numpy(), want_h, atol=1e-6)


def _port_update(weights, batch):
    state = _port_state(weights)
    before = copy.deepcopy(state.policy.state_dict())
    metrics = step.make_train_step(MonitorConfig())(state, batch)
    assert state.step == 1
    return state, before, {k: float(v) for k, v in metrics.items()}


def test_update_matches_jax_fp32(weights, batch, jax_update):
    """One fp32 update: loss and metrics, BN statistics, gradients to
    within fp32 rounding; the frozen parameters untouched, the instruction
    embedding trained."""
    want_vars, want_metrics, _ = jax_update["fp32"]
    exact_grads = jax_update["fp64"][2]
    state, before, metrics = _port_update(weights, batch)
    rel = {k: _rel_l2(p.grad.numpy(), exact_grads[k])
           for k, p in state.policy.named_parameters()
           if p.grad is not None and np.linalg.norm(exact_grads[k]) >= 1e-5}
    # fp32 rounding through train-mode BN, on BN-coupled tensors (measured
    # worst: 1.2e-2 against JAX's float64 gradient)
    worst = max(rel, key=rel.get)
    assert len(rel) > 60 and rel[worst] < 3e-2, (worst, rel[worst])
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():  # measured worst: 1.4e-7 relative
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, err_msg=k)
    after = state.policy.state_dict()
    stats = [k for k in want_vars if k.endswith(("running_mean",
                                                 "running_var"))]
    assert len(stats) == 2 * sum(isinstance(m, BatchNorm2d)
                                 for m in state.policy.modules())
    for k in stats:  # measured worst: 6.0e-7 absolute
        np.testing.assert_allclose(after[k].numpy(), want_vars[k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        # the map modules' statistics move, the eval-mode UNet's do not
        moved = not np.array_equal(after[k].numpy(), before[k].numpy())
        assert moved != k.startswith("net.rgb_encoder."), k
    frozen = [k for k, _ in state.policy.named_parameters()
              if not step.trainable(k)]
    assert "net.depth_encoder.spatial_embeddings.weight" in frozen
    assert any(k.startswith("net.rgb_encoder.") for k in frozen)
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
        assert state.policy.get_parameter(k).grad is None, k
    assert not torch.equal(
        after["net.instruction_encoder.embedding_layer.weight"],
        before["net.instruction_encoder.embedding_layer.weight"])


def test_update_matches_jax_fp64(weights, batch, jax_update):
    """One float64 update (the same code): gradients and post-Adam
    parameters of every trainable tensor, BN statistics."""
    want_vars, want_metrics, want_grads = jax_update["fp64"]
    policy = port_policy(weights).double()
    state = step.create_train_state(policy, device="cpu")
    before = copy.deepcopy(state.policy.state_dict())
    metrics = step.make_train_step(MonitorConfig())(state, _f64(batch))
    assert metrics["loss"].dtype == torch.float64
    # the contrastive target is fp32 on both sides, as in JAX (measured
    # worst: 3.7e-8 relative, on that monitor)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-6,
                                   err_msg=k)
    after = state.policy.state_dict()
    checked = 0
    for k, p in state.policy.named_parameters():
        if not step.trainable(k):
            continue
        g = (p.grad.numpy() if p.grad is not None
             else np.zeros(tuple(p.shape)))
        want = want_grads[k]
        if np.linalg.norm(want) < 1e-5:
            # degenerate direction (a conv bias feeding BN, an unused
            # head): the true gradient is 0, both sides are rounding
            assert np.linalg.norm(g) < 1e-4, k
        else:  # measured worst: 6.6e-7 (the fp32 contrastive target)
            assert _rel_l2(g, want) < 1e-5, (k, _rel_l2(g, want))
            checked += 1
        # Adam's first step is about -lr * sign(g) (lr 2.5e-4), and eps
        # 1e-8 damps it where the gradient is rounding: a flipped sign
        # would show as ~5e-4 (measured worst difference: 4.7e-7)
        np.testing.assert_allclose(after[k].numpy(), want_vars[k], rtol=0,
                                   atol=2e-6, err_msg=k)
    assert checked > 60
    for k in want_vars:  # measured worst: 2.3e-9 of the range
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(after[k].numpy(), want_vars[k],
                                       rtol=1e-7, atol=1e-8, err_msg=k)


def test_biased_running_variance():
    """Train-mode BN moves the running variance by flax's rule (biased
    batch variance, momentum 0.9 on the old value), not torch's."""
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 2, 2).astype(
        np.float32) * 2 + 1)
    bn = BatchNorm2d(3).train()
    bn.running_var.fill_(0.5)
    y = bn(x)
    v = x.numpy().var(axis=(0, 2, 3))
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * 0.5 + 0.1 * v,
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * x.numpy().mean(axis=(0, 2, 3)),
                               rtol=1e-6, atol=1e-7)
    ref = torch.nn.functional.batch_norm(x, None, None, bn.weight, bn.bias,
                                         True, 0.0, bn.eps)
    assert torch.equal(y, ref)


def test_loss_decreases_and_padding_is_masked(weights, batch):
    state = _port_state(weights)
    update = step.make_train_step(MonitorConfig())
    losses = [float(update(state, batch)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses

    # targets on padded steps (weight 0) move no loss term
    state = _port_state(weights)
    base = update(copy.deepcopy(state), batch)
    padded = copy.deepcopy(batch)
    pad = batch["weights"] == 0
    assert pad.sum() == 3
    padded["obs"]["waypoint"][pad] = 123.0
    padded["obs"]["progress"][pad] = -7.0
    padded["obs"]["gt_semantic_map"][pad] = 26
    padded["obs"]["gt_path"][pad] = 0.0
    moved = update(copy.deepcopy(state), padded)
    for k in ("action_loss", "progress_monitor", "prediction_monitor"):
        np.testing.assert_allclose(float(moved[k]), float(base[k]),
                                   rtol=1e-6, err_msg=k)


def test_remat_matches_plain(weights, batch):
    """remat: the same loss, gradients and BN statistics (measured: bit
    for bit on the CPU); the statistics move once."""
    out = {}
    for remat in (False, True):
        state = _port_state(weights)
        m = step.make_train_step(MonitorConfig(), remat=remat)(state, batch)
        out[remat] = (float(m["loss"]),
                      {k: p.grad.clone() for k, p in
                       state.policy.named_parameters() if p.grad is not None},
                      {k: v.clone() for k, v in
                       state.policy.state_dict().items()})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    assert out[True][1].keys() == out[False][1].keys()
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=1e-5, atol=1e-7)
    for k, v in out[False][2].items():
        torch.testing.assert_close(out[True][2][k], v, rtol=1e-6, atol=1e-7)
    nbt = {k: int(v) for k, v in out[True][2].items()
           if k.endswith("num_batches_tracked")}
    assert len(nbt) == sum(isinstance(m, BatchNorm2d)
                           for m in port_policy(weights).modules())
    for k, n in nbt.items():  # the eval-mode UNet's never move
        assert n == (0 if k.startswith("net.rgb_encoder.") else 1), k


def test_train_state_defaults_to_the_card(weights):
    if torch.cuda.is_available():
        assert _port_state(weights, None).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        step.create_train_state(port_policy(weights))
