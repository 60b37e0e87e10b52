"""The fused convs' prepared operands (folded BN, the weight in its
kernel's layout), built once and cached on the conv module: the cached
path computes what the per-call preparation computed, and any change to a
source tensor rebuilds it. On the CPU through the kernels' plain twin; the
``gpu`` case runs the kernels on the card. No JAX."""
import copy

import pytest
import torch

from ws_mgmap_tpu_torch.models.layers import (ConvBNReLU, fused_conv_bn,
                                              fused_operands)
from ws_mgmap_tpu_torch.models.resnet import BasicBlock
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv


def _module(seed=0, ci=10, co=12):
    torch.manual_seed(seed)
    m = ConvBNReLU(ci, co, 3, 1).eval()
    with torch.no_grad():
        m[1].running_mean.uniform_(-0.5, 0.5)
        m[1].running_var.uniform_(0.5, 1.5)
        m[1].weight.uniform_(0.5, 1.5)
        m[1].bias.uniform_(-0.2, 0.2)
    return m


def _inputs(c=(6, 4), dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    return [torch.randn(2, ci, 12, 16, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last) for ci in c]


def _uncached(x, x2, conv, bn, relu=True, residual=None):
    """What fused_conv_bn computed before the cache: fold and re-lay the
    weight on every call, HWIO."""
    scale, bias = kconv.fold_bn(conv.bias, bn.weight, bn.bias,
                                bn.running_mean, bn.running_var, bn.eps)
    w = conv.weight.permute(2, 3, 1, 0).contiguous().to(x.dtype)

    def nhwc(t):
        return None if t is None else t.permute(0, 2, 3, 1).contiguous()

    y = kconv.conv3x3_bn_relu(nhwc(x), w, scale, bias, relu=relu,
                              residual=nhwc(residual), x2=nhwc(x2))
    return y.permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_path_equals_uncached(dtype):
    m = _module().to(dtype)
    x, x2 = _inputs(dtype=dtype)
    with torch.no_grad():
        first = fused_conv_bn(x, m[0], m[1], relu=True, x2=x2)
        ops = fused_operands(m[0], m[1], dtype, "direct")
        second = fused_conv_bn(x, m[0], m[1], relu=True, x2=x2)
        want = _uncached(x, x2, m[0], m[1])
    # ragged channels: the direct kernel's HWIO weight; the second call
    # reuses the operands of the first
    assert kconv.conv_variant(dtype, 6, 4, 12) == "direct"
    assert all(a is b for a, b in zip(ops, fused_operands(m[0], m[1], dtype,
                                                          "direct")))
    assert ops[2].shape == (3, 3, 10, 12) and ops[2].dtype == dtype
    assert torch.equal(first, want) and torch.equal(second, want)


def test_cached_wgmma_operands_are_packed_once():
    m = _module(ci=128, co=72).to(torch.bfloat16)
    x, x2 = _inputs(c=(64, 64), dtype=torch.bfloat16)
    with torch.no_grad():
        got = fused_conv_bn(x, m[0], m[1], relu=True, x2=x2)
        ops = fused_operands(m[0], m[1], torch.bfloat16, "wgmma")
        want = _uncached(x, x2, m[0], m[1])
    assert kconv.conv_variant(torch.bfloat16, 64, 64, 72) == "wgmma"
    assert ops[2].shape == (9 * 72, 128) and ops[2].dtype == torch.bfloat16
    assert torch.equal(ops[2], kconv.pack_weight(
        m[0].weight.detach().permute(2, 3, 1, 0)))
    assert fused_operands(m[0], m[1], torch.bfloat16, "wgmma")[2] is ops[2]
    assert torch.equal(got, want)


def test_cached_block_with_residual_equals_uncached():
    torch.manual_seed(3)
    blk = BasicBlock(8, 8).eval()
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            bn.running_var.uniform_(0.5, 1.5)
            bn.running_mean.uniform_(-0.3, 0.3)
    x = _inputs(c=(8,))[0]
    with torch.no_grad():
        for _ in range(2):
            got = fused_conv_bn(x, blk.conv2, blk.bn2, relu=False,
                                residual=x)
            want = _uncached(x, None, blk.conv2, blk.bn2, relu=False,
                             residual=x)
            assert torch.equal(got, want)


def _edit_running_var(m):
    with torch.no_grad():
        m[1].running_var.mul_(4.0)


def _load_other_state(m):
    m.load_state_dict(_module(seed=5).state_dict())


def _edit_weight(m):
    with torch.no_grad():
        m[0].weight[0].neg_()


def _to_bf16_and_back(m):
    m.to(torch.bfloat16).to(torch.float32)  # new tensors, bf16-rounded


@pytest.mark.parametrize("change", [_edit_running_var, _load_other_state,
                                    _edit_weight, _to_bf16_and_back])
def test_cache_rebuilds_when_a_source_changes(change):
    m = _module()
    x, x2 = _inputs()
    with torch.no_grad():
        before = fused_conv_bn(x, m[0], m[1], relu=False, x2=x2)
        change(m)
        after = fused_conv_bn(x, m[0], m[1], relu=False, x2=x2)
        want = _uncached(x, x2, m[0], m[1], relu=False)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


def test_deepcopy_and_cast_rebuild_for_the_copy():
    m = _module()
    x, x2 = _inputs()
    with torch.no_grad():
        fused_conv_bn(x, m[0], m[1], relu=True, x2=x2)
        c = copy.deepcopy(m).to(torch.bfloat16)
        got = fused_conv_bn(x.bfloat16(), c[0], c[1], relu=True,
                            x2=x2.bfloat16())
        want = _uncached(x.bfloat16(), x2.bfloat16(), c[0], c[1])
    assert fused_operands(c[0], c[1], torch.bfloat16, "direct")[2].dtype == \
        torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("c1,c2,co", [(8, 0, 16), (6, 10, 7), (64, 64, 72)])
def test_packed_weight_twin_equals_hwio_twin(c1, c2, co):
    g = torch.Generator().manual_seed(c1 + co)
    x = torch.randn(2, 9, 11, c1, generator=g)
    x2 = torch.randn(2, 9, 11, c2, generator=g) if c2 else None
    w = torch.randn(3, 3, c1 + c2, co, generator=g) * 0.1
    s, b = torch.rand(co, generator=g) + 0.5, torch.randn(co, generator=g)
    want = kconv.conv3x3_bn_relu_plain(x, w, s, b, relu=True, x2=x2)
    # each wrapper on a CPU tensor: the twin, on its kernel's layout
    assert torch.equal(kconv.conv3x3_bn_relu_wgmma(
        x, kconv.pack_weight(w), s, b, relu=True, x2=x2), want)
    for variant, wrapper in kconv.KERNELS.items():
        assert torch.equal(wrapper(x, kconv.kernel_weight(w, variant), s, b,
                                   relu=True, x2=x2), want)
    assert torch.equal(kconv.conv3x3_bn_relu(x, w, s, b, relu=True, x2=x2),
                       want)


@pytest.mark.gpu
def test_cache_rebuilds_after_a_cast_round_trip_on_the_card():
    """``.to(bf16).to(fp32)`` gives the parameters new, bf16-rounded
    storages; the caching allocator may hand out the freed blocks again,
    at the same addresses and with the same version counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    m = _module().cuda()
    x, x2 = (t.cuda() for t in _inputs())
    with torch.no_grad():
        before = fused_conv_bn(x, m[0], m[1], relu=False, x2=x2)
        for _ in range(3):
            m.to(torch.bfloat16).to(torch.float32)
            after = fused_conv_bn(x, m[0], m[1], relu=False, x2=x2)
            want = _uncached(x, x2, m[0], m[1], relu=False)
            assert torch.equal(after, want)
    assert not torch.equal(before, after)  # the weights were rounded
