"""The port's ResNet18-UNet vs the JAX UNet, with weights carried over by
``from_jax_variables`` (width_mult 0.125, 64x64 input)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.models.unet import UNet as JUNet
from ws_mgmap_tpu.ops.pallas import conv as jconv
from ws_mgmap_tpu.utils.convert import export_torch_state
from ws_mgmap_tpu_torch.models.unet import UNet
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables

WIDTH = 0.125


def _perturb_bn(variables, rng):
    """Non-trivial BN statistics and affines, so fold_bn is exercised."""
    def walk(tree, stats):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
            elif stats and k == "mean":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif stats and k == "var":
                out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
            elif not stats and k == "scale":
                out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


@pytest.fixture(scope="module")
def unet_pair():
    rng = np.random.RandomState(21)
    x = rng.randint(0, 255, (2, 64, 64, 3)).astype(np.float32)
    jm = JUNet(width_mult=WIDTH)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    variables = _perturb_bn(variables, rng)
    tm = UNet(width_mult=WIDTH)
    sd = from_jax_variables(variables, prefixes=("base_model.",))
    tm.load_state_dict(sd, strict=True)
    return jm, variables, tm.eval(), x, sd


def test_weight_carry_over_equals_export_torch_state(unet_pair):
    _, variables, tm, _, sd = unet_pair
    exported = export_torch_state(variables)
    own = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert own == set(exported)
    for k in own:
        np.testing.assert_array_equal(sd[k].numpy(), exported[k], err_msg=k)
    # strict load filled every parameter and buffer of the module
    assert set(tm.state_dict()) == set(sd)


def _run_both(unet_pair, dtype, fused):
    jm, variables, tm, x, _ = unet_pair
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jvars = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), variables)
    if fused:
        jconv.set_fused_conv_mode("on")
        kconv.set_fused_conv_mode("on")
    try:
        want = jm.apply(jvars, jnp.asarray(x).astype(jdt), False)
        with torch.no_grad():
            got = copy.deepcopy(tm).to(dtype)(torch.from_numpy(x).to(dtype))
    finally:
        jconv.set_fused_conv_mode("auto")
        kconv.set_fused_conv_mode("auto")
    return ([np.asarray(w, np.float32) for w in want],
            [g.float().numpy() for g in got])


@pytest.mark.parametrize("fused", [False, True])
def test_unet_fp32_matches_jax(unet_pair, fused):
    want, got = _run_both(unet_pair, torch.float32, fused)
    for name, w, g in zip(("bottleneck", "proj_feat", "seg"), want, got):
        assert g.shape == w.shape, name
        # ~20 fp32 conv layers summing in another order: 1e-4 of the
        # output's range
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_unet_bf16_matches_jax(unet_pair):
    want, got = _run_both(unet_pair, torch.bfloat16, fused=True)
    for name, w, g in zip(("bottleneck", "proj_feat", "seg"), want, got):
        # bf16 activations (2^-8 relative rounding) rounded at different
        # points by the two frameworks through ~20 layers: measured mean
        # error 0.5-1.2% of the mean magnitude and worst element 1.1-1.6%
        # of the range (a few bf16 ulps of the largest values)
        scale = float(np.abs(w).max())
        err = np.abs(g - w)
        assert err.mean() <= 2e-2 * float(np.abs(w).mean()), name
        assert err.max() <= 3e-2 * scale, (name, err.max(), scale)
