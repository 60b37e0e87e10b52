"""The port's CUDA kernels vs their plain PyTorch twins, and the wrappers'
dispatch and checks. Imports torch and the port only, so it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

The card tests are marked ``gpu`` and skip without a card.
"""
import numpy as np
import pytest
import torch

from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.ops.kernels import splat as ksplat

EGO = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # fp32 twins in full fp32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = allow


def _splat_inputs(rng, b, p, c):
    feats = (rng.randn(b, p, c) * 2.0).astype(np.float32)
    ids = rng.randint(0, EGO * EGO, (b, p)).astype(np.int32)
    crowd = rng.rand(b, p) < 0.3
    ids[crowd] = rng.randint(0, 6, crowd.sum())
    ids[rng.rand(b, p) < 0.75] = -1
    return torch.from_numpy(feats), torch.from_numpy(ids)


def test_splat_twin_zeroes_eps_maxima():
    # a max <= -1e16 is the reference's invalid sentinel: written as 0
    feats = torch.full((1, 4, 2), -2e16)
    feats[0, 1] = torch.tensor([-1e15, 3.0])
    ids = torch.tensor([[0, 0, 5, -1]], dtype=torch.int32)
    out = ksplat.splat_max(feats, ids, EGO).reshape(EGO * EGO, 2)
    assert torch.equal(out[0], feats[0, 1])
    assert torch.equal(out[5], torch.zeros(2))
    assert torch.count_nonzero(out[1:5]) == 0


def test_cpu_tensors_take_the_twins_without_counting():
    rng = np.random.RandomState(0)
    feats, ids = _splat_inputs(rng, 2, 64, 4)
    before = ksplat.splat_max.launches
    assert torch.equal(ksplat.splat_max(feats, ids, EGO),
                       ksplat.splat_max_plain(feats, ids, EGO))
    x = torch.randn(1, 8, 8, 4)
    w, s, b = torch.randn(3, 3, 4, 5), torch.ones(5), torch.zeros(5)
    cbefore = kconv.conv3x3_bn_relu.launches
    assert torch.equal(kconv.conv3x3_bn_relu(x, w, s, b),
                       kconv.conv3x3_bn_relu_plain(x, w, s, b))
    assert ksplat.splat_max.launches == before
    assert kconv.conv3x3_bn_relu.launches == cbefore


def test_conv_rejects_residual_with_x2():
    x = torch.randn(1, 8, 8, 4)
    with pytest.raises(ValueError):
        kconv.conv3x3_bn_relu(x, torch.randn(3, 3, 8, 4), torch.ones(4),
                              torch.zeros(4), residual=x, x2=x)


@pytest.mark.gpu
@pytest.mark.parametrize("b,dtype", [(2, torch.float32), (6, torch.bfloat16),
                                     (13, torch.bfloat16)])
def test_splat_kernel_matches_twin(cuda, b, dtype):
    feats, ids = _splat_inputs(np.random.RandomState(b), b, 4096, 64)
    f, i = feats.to(cuda, dtype), ids.to(cuda)
    before = ksplat.splat_max.launches
    got = ksplat.splat_max(f, i, EGO)
    torch.cuda.synchronize()
    assert ksplat.splat_max.launches == before + 1
    # order-independent max: exact
    assert torch.equal(got, ksplat.splat_max_plain(f, i, EGO))


@pytest.mark.gpu
def test_splat_kernel_rejects_bad_operands(cuda):
    f = torch.zeros(2, 16, 4, device=cuda)
    with pytest.raises(TypeError):
        ksplat.splat_max(f, torch.zeros(2, 16, dtype=torch.int64,
                                        device=cuda), EGO)
    with pytest.raises(ValueError):
        ksplat.splat_max(f[:, ::2], torch.zeros(2, 8, dtype=torch.int32,
                                                device=cuda), EGO)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 0, 16),
                                   (1, 32, 20, 5, 0, 7),
                                   (2, 28, 28, 96, 32, 70),
                                   (1, 14, 14, 64, 0, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_twin(cuda, shape, dtype):
    b, h, w, c1, c2, co = shape
    g = torch.Generator(device=cuda).manual_seed(c1 * 100 + co)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda) * scale

    x = rnd(b, h, w, c1).to(dtype)
    x2 = rnd(b, h, w, c2).to(dtype) if c2 else None
    k = rnd(3, 3, c1 + c2, co, scale=0.1).to(dtype)
    s, bb = rnd(co).abs() + 0.5, rnd(co, scale=0.1)
    res = None if c2 else rnd(b, h, w, co).to(dtype)
    before = kconv.conv3x3_bn_relu.launches
    got = kconv.conv3x3_bn_relu(x, k, s, bb, relu=True, residual=res, x2=x2)
    torch.cuda.synchronize()
    assert kconv.conv3x3_bn_relu.launches == before + 1
    want = kconv.conv3x3_bn_relu_plain(x, k, s, bb, relu=True, residual=res,
                                       x2=x2)
    # both sum in fp32 in different orders; bf16 outputs may then round
    # one bf16 ulp (2^-7 relative) apart
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-3 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
def test_conv_kernel_rejects_bad_operands(cuda):
    x = torch.randn(1, 8, 8, 4, device=cuda)
    w, s, b = (torch.randn(3, 3, 4, 5, device=cuda),
               torch.ones(5, device=cuda), torch.zeros(5, device=cuda))
    with pytest.raises(TypeError):
        kconv.conv3x3_bn_relu(x, w.bfloat16(), s, b)
    with pytest.raises(ValueError):
        kconv.conv3x3_bn_relu(x.permute(0, 2, 1, 3), w, s, b)
    with pytest.raises(TypeError):
        kconv.conv3x3_bn_relu(x.half(), w.half(), s, b)
