"""The port's data-parallel update against the JAX package's: 2 gloo
ranks of the port's worker, each fed its shard through the port's
``ReplayLoader``, against ``jit_train_step(make_train_step(...),
make_mesh(dp=2))`` on the same global batch, from the same JAX weights, in
float64 on both sides (``jax.enable_x64``). Tolerances are the float64
ones of the single-process update (``tests/test_torch_train_step.py``):
loss and metrics 1e-5 relative, gradients 1e-5 relative L2, post-Adam
parameters 2e-6 absolute; the BN statistics 1e-6 relative. Measured worst
here: metrics 2.0e-7, gradients 1.2e-6, parameters 2.2e-7, statistics
9.1e-8 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_dist_train import F64, make_run_dir
from tests.torch_port_common import (SMALL, init_policy_variables,
                                     jax_config, port_policy)
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.parallel import mesh as jmesh
from ws_mgmap_tpu.train import losses as jlosses
from ws_mgmap_tpu.train import step as jstep
from ws_mgmap_tpu.utils.convert import export_torch_state
from ws_mgmap_tpu_torch.tools import dist_train_check as dtc

H = SMALL["hidden_size"]


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32 else a, tree)


def _torch_tree(variables, policy):
    """JAX variables (params, batch_stats or grads) as torch-keyed numpy."""
    shapes = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
    return export_torch_state(variables, reference_shapes=shapes)


def jax_dp_update(weights, batch):
    """JAX's update of the global batch over a 2-device dp mesh: (new
    variables, metrics, gradients), torch-keyed numpy, float64."""
    policy = JPolicy(jax_config())
    opt = jstep.make_optimizer(2.5e-4)
    update = jstep.make_train_step(policy, opt, jlosses.MonitorConfig(), H)
    template = port_policy(weights)
    n = batch["weights"].shape[0]
    with jax.enable_x64(True):
        v, jb = jax.tree.map(jnp.asarray, (_f64(weights), _f64(batch)))

        def loss_fn(params):
            (pred, aux), _ = policy.apply(
                {"params": params, "batch_stats": v["batch_stats"]},
                jb["obs"], jnp.zeros((2, n, H)), jb["not_done_masks"], True,
                method=JPolicy.forward_seq, mutable=["batch_stats"])
            return jlosses.total_loss(pred, aux, jb["obs"], jb["weights"],
                                      jlosses.MonitorConfig())[0]

        grads = jax.device_get(jax.jit(jax.grad(loss_fn))(v["params"]))
        mesh = jmesh.make_mesh(dp=2)  # the update donates its state: last
        state = jmesh.replicate(mesh, jstep.create_train_state(v, opt))
        new_state, metrics = jstep.jit_train_step(update, mesh)(
            state, jmesh.shard_batch(mesh, jb))
        return (_torch_tree(jax.device_get({
                    "params": new_state.params,
                    "batch_stats": new_state.batch_stats}), template),
                {k: float(m) for k, m in metrics.items()},
                _torch_tree({"params": grads}, template))


def test_two_ranks_match_jax_dp_mesh(tmp_path):
    weights = init_policy_variables(3)
    d = tmp_path / "run"
    spec = make_run_dir(d, 2, [F64], port_policy(weights).state_dict())
    dtc.launch_ranks(2, d, 240)
    ranks = [torch.load(d / f"rank{r}.pt")[0] for r in range(2)]
    run = spec["runs"][0]
    batch = dtc.concat_batches([dtc.rank_batch(run, d, r, 2)
                                for r in range(2)])
    assert batch["weights"].shape == (4, 6)
    want_vars, want_metrics, want_grads = jax_dp_update(weights, batch)
    for got in ranks:
        assert got["metrics"].keys() == want_metrics.keys()
        for k, v in want_metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        checked = 0
        for k, g in got["grads"].items():
            want = want_grads[k]
            # Adam's first step is about -lr * sign(g): a degenerate
            # direction's sign is rounding, damped by eps
            np.testing.assert_allclose(got["state"][k].numpy(), want_vars[k],
                                       rtol=0, atol=2e-6, err_msg=k)
            if np.linalg.norm(want) < 1e-5:
                assert float(g.norm()) < 1e-4, k
                continue
            rel = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
            assert rel < 1e-5, (k, rel)
            checked += 1
        assert checked > 60
        stats = [k for k in want_vars if k.endswith(("running_mean",
                                                     "running_var"))]
        assert len(stats) > 20
        for k in stats:
            np.testing.assert_allclose(got["state"][k].numpy(), want_vars[k],
                                       rtol=1e-6, atol=1e-8, err_msg=k)
