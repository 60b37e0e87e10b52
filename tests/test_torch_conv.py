"""The fused conv's plain twin vs the JAX Pallas kernel, fold_bn and the
gate. The CUDA kernel is held against the twin in test_torch_kernels.py.

The JAX kernel runs in Pallas interpret mode on the CPU. Shapes are the
JAX package's own kernel-test shapes (ragged channels, 1-7 row tiles).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.ops.pallas import conv as jconv
from ws_mgmap_tpu_torch.models.layers import ConvBNReLU
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv

RNG = np.random.RandomState(7)


def _operands(b, h, w, c1, c2, co, residual=False):
    x = RNG.randn(b, h, w, c1).astype(np.float32)
    x2 = RNG.randn(b, h, w, c2).astype(np.float32) if c2 else None
    k = (RNG.randn(3, 3, c1 + c2, co) * 0.1).astype(np.float32)
    s = (RNG.rand(co) + 0.5).astype(np.float32)
    bb = (RNG.randn(co) * 0.1).astype(np.float32)
    r = RNG.randn(b, h, w, co).astype(np.float32) if residual else None
    return x, x2, k, s, bb, r


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("shape", [
    (2, 16, 24, 8, 16),
    (1, 32, 20, 5, 7),
    (2, 8, 8, 3, 4),
    (1, 56, 12, 6, 10),
])
@pytest.mark.parametrize("relu", [True, False])
def test_twin_matches_jax_kernel(shape, relu):
    b, h, w, ci, co = shape
    x, _, k, s, bb, _ = _operands(b, h, w, ci, 0, co)
    want = np.asarray(jconv.conv3x3_bn_relu(_j(x), _j(k), _j(s), _j(bb),
                                            relu=relu))
    got = kconv.conv3x3_bn_relu(_t(x), _t(k), _t(s), _t(bb), relu=relu)
    # fp32 sums in another order: the JAX kernel test's own tolerance
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 4, 16),
                                   (1, 32, 20, 6, 10, 7)])
def test_twin_matches_jax_kernel_two_inputs(shape):
    b, h, w, c1, c2, co = shape
    x, x2, k, s, bb, _ = _operands(b, h, w, c1, c2, co)
    want = np.asarray(jconv.conv3x3_bn_relu(_j(x), _j(k), _j(s), _j(bb),
                                            relu=True, x2=_j(x2)))
    got = kconv.conv3x3_bn_relu(_t(x), _t(k), _t(s), _t(bb), relu=True,
                                x2=_t(x2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("relu", [True, False])
def test_twin_matches_jax_kernel_residual(relu):
    x, _, k, s, bb, r = _operands(2, 16, 12, 8, 0, 8, residual=True)
    want = np.asarray(jconv.conv3x3_bn_relu(_j(x), _j(k), _j(s), _j(bb),
                                            relu=relu, residual=_j(r)))
    got = kconv.conv3x3_bn_relu(_t(x), _t(k), _t(s), _t(bb), relu=relu,
                                residual=_t(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fold_bn_matches_jax():
    co = 9
    args = [(RNG.randn(co) * 0.2).astype(np.float32) for _ in range(4)]
    args[3] = (RNG.rand(co) + 0.3).astype(np.float32)  # variance > 0
    bias0 = RNG.randn(co).astype(np.float32)
    js, jb = jconv.fold_bn(None, _j(bias0), *[_j(a) for a in args])
    ts, tb = kconv.fold_bn(_t(bias0), *[_t(a) for a in args])
    # rsqrt and one multiply-add in fp32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_fused_module_matches_conv_bn_relu():
    """ConvBNReLU with the fused path forced on (the twin on the CPU) ==
    the module's own Conv2d -> BatchNorm2d -> ReLU, with a concat input."""
    torch.manual_seed(0)
    m = ConvBNReLU(10, 12, 3, 1).eval()
    with torch.no_grad():
        m[1].running_mean.uniform_(-0.5, 0.5)
        m[1].running_var.uniform_(0.5, 1.5)
        m[1].weight.uniform_(0.5, 1.5)
        m[1].bias.uniform_(-0.2, 0.2)
    x = torch.randn(2, 6, 16, 16).contiguous(memory_format=torch.channels_last)
    x2 = torch.randn(2, 4, 16, 16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = m(x, x2)
        kconv.set_fused_conv_mode("on")
        try:
            got = m(x, x2)
        finally:
            kconv.set_fused_conv_mode("auto")
    # BN folded into scale/bias vs applied after: fp32 rounding only
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


GATE_SHAPES = [
    ((1, 224, 224, 64), 3, 1), ((6, 224, 224, 192), 3, 1),
    ((6, 112, 112, 320), 3, 1), ((6, 56, 56, 64), 3, 1),
    ((6, 14, 14, 768), 3, 1), ((6, 7, 7, 512), 3, 1),
    ((6, 224, 224, 3), 3, 1), ((6, 224, 224, 64), 3, 2),
    ((6, 224, 224, 64), 1, 1), ((1, 4, 224, 64), 3, 1),
    ((1, 9, 9, 16), 3, 1), ((1, 22, 22, 16), 3, 1),
    ((1, 12, 30, 16), 3, 1), ((1, 21, 21, 8), 3, 1),
    ((1, 64, 5, 8), 3, 1), ((1, 8, 8, 8), 3, 1),
]


@pytest.mark.parametrize("shape,kernel,stride", GATE_SHAPES)
def test_gate_agrees_with_jax(shape, kernel, stride):
    assert (kconv.fused_conv_eligible(shape, kernel, stride)
            == jconv.fused_conv_eligible(shape, kernel, stride))


def test_auto_mode_fuses_bf16_and_fp32_on_the_card_only():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    shape = (1, 224, 224, 64)
    assert kconv.fused_conv_active(shape, torch.bfloat16, gpu, 3, 1)
    assert kconv.fused_conv_active(shape, torch.float32, gpu, 3, 1)
    assert not kconv.fused_conv_active(shape, torch.float16, gpu, 3, 1)
    assert not kconv.fused_conv_active(shape, torch.bfloat16, cpu, 3, 1)
    assert not kconv.fused_conv_active(shape, torch.float32, cpu, 3, 1)
    kconv.set_fused_conv_mode("off")
    try:
        assert not kconv.fused_conv_active(shape, torch.bfloat16, gpu, 3, 1)
    finally:
        kconv.set_fused_conv_mode("auto")
    with pytest.raises(ValueError):
        kconv.set_fused_conv_mode("maybe")

