"""The port's map encoder, decoder and classifier and its action and value
heads vs the JAX package's, with weights carried over by
``from_jax_variables`` and non-trivial BN statistics.

The decoder is fed at 16x16: there all four of its 3x3 ConvBNReLU sites
pass the fused-conv gate (a height with a divisor in {16, 14, 8, 7, 4}
and at least 8x8; ``conv_up0`` runs at 8x8), so with fused mode "on"
both packages fuse all four (JAX: Pallas in interpret mode; the port:
its kernel wrappers, which run their twins on CPU tensors), and with
"off" neither fuses any. At the usual test ego size of 20 the decoder
runs at 4x4, where nothing fuses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import perturb_norms
from ws_mgmap_tpu.models.distributions import CriticHead as JCriticHead
from ws_mgmap_tpu.models.distributions import DiagGaussian as JDiagGaussian
from ws_mgmap_tpu.models.map_modules import MapClassifier as JMapClassifier
from ws_mgmap_tpu.models.map_modules import MapDecoder as JMapDecoder
from ws_mgmap_tpu.models.map_modules import MapEncoder as JMapEncoder
from ws_mgmap_tpu.ops.pallas import conv as jconv
from ws_mgmap_tpu_torch.models import layers
from ws_mgmap_tpu_torch.models.distributions import CriticHead, DiagGaussian
from ws_mgmap_tpu_torch.models.map_modules import (MapClassifier, MapDecoder,
                                                   MapEncoder)
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables


def _pair(jmod, tmod, x, seed, *args):
    """Initialize ``jmod`` on ``x``, perturb its norms, load the port."""
    rng = np.random.RandomState(seed)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jmod.init(k, jnp.asarray(x), *args))(
            jax.random.PRNGKey(seed)))
    variables = perturb_norms(variables, rng)
    sd = from_jax_variables(variables, prefixes=("",))
    assert set(sd) == set(tmod.state_dict())
    tmod.load_state_dict(sd, strict=True)
    return variables, tmod.eval()


def _nchw(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def test_map_encoder():
    x = np.random.RandomState(7).rand(2, 20, 20, 8).astype(np.float32)
    variables, tmod = _pair(JMapEncoder(8, 32), MapEncoder(8, 32), x, 7,
                            False)
    want = np.asarray(JMapEncoder(8, 32).apply(variables, jnp.asarray(x),
                                               False))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    assert got.shape == want.shape == (2, MapEncoder.output_hw(20),
                                       MapEncoder.output_hw(20), 32)
    # three convs summed in other orders: measured worst 5.8e-7 of the
    # range
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("mode,dtype", [("on", torch.float32),
                                        ("off", torch.float32),
                                        ("on", torch.bfloat16)])
def test_map_decoder_at_16x16(mode, dtype, monkeypatch):
    x = np.random.RandomState(8).rand(2, 16, 16, 32).astype(np.float32)
    jdec = JMapDecoder(32)
    variables, tmod = _pair(jdec, MapDecoder(32), x, 8, False)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jvars = jax.tree.map(lambda a: jnp.asarray(a, jdtype), variables)
    tmod = tmod.to(dtype)
    fused = {"jax": 0, "port": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            fused[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jconv, "conv3x3_bn_relu",
                        count("jax", jconv.conv3x3_bn_relu))
    monkeypatch.setattr(layers, "fused_conv_bn",
                        count("port", layers.fused_conv_bn))
    jconv.set_fused_conv_mode(mode)
    kconv.set_fused_conv_mode(mode)
    try:
        want = np.asarray(jdec.apply(jvars, jnp.asarray(x, jdtype), False),
                          np.float32)
        with torch.no_grad():
            got = _nhwc(tmod(_nchw(x, dtype)))
    finally:
        jconv.set_fused_conv_mode("auto")
        kconv.set_fused_conv_mode("auto")
    n = 4 if mode == "on" else 0
    assert fused == {"jax": n, "port": n}
    assert got.shape == want.shape == (2, 16, 16, 64)
    scale = float(np.abs(want).max())
    if dtype == torch.float32:
        # fp32 sums in other orders: measured worst 5.5e-7 of the range
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        # bf16 activations rounded at different points by the two
        # frameworks (JAX rounds inside the upsample's matmuls): measured
        # worst element 0.4% of the range, mean error 0.02% of it
        err = np.abs(got - want)
        assert err.max() <= 1e-2 * scale, err.max() / scale
        assert err.mean() <= 1e-3 * scale, err.mean() / scale


def test_map_classifier_conv_transpose():
    """The ConvTranspose2d carry-over: the JAX ``kernel_t`` [kh, kw, I, O]
    leaf becomes torch's [I, O, kh, kw] with its spatial flip."""
    x = np.random.RandomState(9).randn(2, 6, 6, 64).astype(np.float32)
    variables, tmod = _pair(JMapClassifier(27), MapClassifier(27), x, 9,
                            False)
    assert tmod[0].weight.shape == (64, 32, 4, 4)
    want = np.asarray(JMapClassifier(27).apply(variables, jnp.asarray(x),
                                               False))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    assert got.shape == want.shape == (2, 12, 12, 27)
    # measured worst 2.7e-7 of the range
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_diag_gaussian_and_critic():
    rng = np.random.RandomState(10)
    feats = rng.randn(5, 16).astype(np.float32)
    actions = rng.randn(5, 2).astype(np.float32)
    variables, dist_mod = _pair(JDiagGaussian(16, 2), DiagGaussian(16, 2),
                                feats, 10)
    assert dist_mod.logstd._bias.shape == (2, 1)
    assert np.abs(variables["params"]["logstd._bias"]).min() > 0
    jd = JDiagGaussian(16, 2).apply(variables, jnp.asarray(feats))
    with torch.no_grad():
        td = dist_mod(torch.from_numpy(feats))
        t_act = torch.from_numpy(actions)
        pairs = [(td.mean, jd.mean), (td.logstd, jd.logstd),
                 (td.mode(), jd.mode()),
                 (td.log_probs(t_act), jd.log_probs(jnp.asarray(actions))),
                 (td.entropy(), jd.entropy())]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    cvars, critic = _pair(JCriticHead(16), CriticHead(16), feats, 11)
    with torch.no_grad():
        got = critic(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JCriticHead(16).apply(cvars, jnp.asarray(feats))),
        rtol=1e-6, atol=1e-6)
    fresh = CriticHead(16).requires_grad_(False)  # orthogonal, zero bias
    assert abs(float(fresh.fc.weight.norm()) - 1.0) < 1e-6
    assert not fresh.fc.bias.any()


def test_diag_gaussian_sample_from_generator():
    dist_mod = DiagGaussian(16, 2)
    with torch.no_grad():
        dist_mod.logstd._bias.copy_(torch.tensor([[-0.5], [0.7]]))
        d = dist_mod(torch.randn(1, 16).expand(20000, 16))
        a = d.sample(torch.Generator().manual_seed(3))
        again = d.sample(torch.Generator().manual_seed(3))
    assert a.shape == (20000, 2)
    torch.testing.assert_close(a, again, rtol=0, atol=0)
    z = ((a - d.mean) / d.logstd.exp()).detach().numpy()
    # 20000 draws: the mean within 5 standard errors, the std within 3%
    np.testing.assert_allclose(z.mean(0), 0.0, atol=5 / np.sqrt(20000))
    np.testing.assert_allclose(z.std(0), 1.0, atol=0.03)
