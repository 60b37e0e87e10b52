"""The port's pooling, rotation and back-projection vs the JAX package.

Inputs come from a numpy seed and go through both; the port runs on the
CPU. Each assertion states its tolerance and why.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.ops import pooling as jpool
from ws_mgmap_tpu.ops import projection as jproj
from ws_mgmap_tpu.ops import resample as jres
from ws_mgmap_tpu_torch.ops import pooling, projection, resample

RNG = np.random.RandomState(11)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("out", [64, 10])
def test_adaptive_max_pool_lastdim(out):
    x = RNG.randn(2, 5, 64).astype(np.float32)
    want = _np(jpool.adaptive_max_pool_lastdim(jnp.asarray(x), out))
    got = pooling.adaptive_max_pool_lastdim(_t(x), out).numpy()
    # a max selects one of the inputs: exact
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(7, 7), (14, 10)])
def test_upsample_bilinear_x2_matches_interpolation_matrix(hw):
    x = RNG.randn(2, *hw, 6).astype(np.float32)
    want = _np(jpool.upsample_bilinear_x2_nhwc(jnp.asarray(x)))
    got = pooling.upsample_bilinear_x2_nhwc(_t(x)).numpy()
    # F.interpolate vs JAX's fp32 interpolation-matrix einsum: the same
    # 2-tap weights, fp32 rounding of the tap weights and the sum only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rotation_theta_both_conventions():
    ang = RNG.uniform(-np.pi, np.pi, 5).astype(np.float32)
    for cw in (False, True):
        want = _np(jres.rotation_theta(jnp.asarray(ang), clockwise_xy=cw))
        got = resample.rotation_theta(_t(ang), clockwise_xy=cw).numpy()
        # cos/sin of the same fp32 angle
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_rotate_about_center_fp32():
    img = RNG.randn(3, 20, 20, 5).astype(np.float32)
    ang = np.array([0.0, 0.7, -2.4], np.float32)
    want = _np(jres.rotate_about_center(jnp.asarray(img), jnp.asarray(ang)))
    got = resample.rotate_about_center(_t(img), _t(ang)).numpy()
    # F.affine_grid/grid_sample vs the JAX gather: the base grid and the
    # unnormalization round differently in fp32 (~1e-6 px), so bilinear
    # weights differ by ~1e-6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rotate_about_center_bf16():
    img = (RNG.rand(2, 20, 20, 4) * 4).astype(ml_dtypes.bfloat16)
    ang = np.array([0.3, -1.9], np.float32)
    want = _np(jres.rotate_about_center(jnp.asarray(img), jnp.asarray(ang)))
    got = resample.rotate_about_center(
        torch.from_numpy(img.astype(np.float32)).to(torch.bfloat16),
        _t(ang))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # the port samples in fp32 and rounds once; JAX blends in bf16 (four
    # rounded products and three rounded sums): a few bf16 ulps of the
    # largest value, 2^-8 relative each
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2**-8 * 4)


def _depth(b, h, w, scale=8.0):
    d = (RNG.rand(b, h, w, 1) * scale).astype(np.float32)
    d[0, : h // 6] = 0.0  # zero depth is invalid
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotate", [False, True])
def test_spatial_locs_bins_every_pixel_like_jax(dtype, rotate):
    depth = _depth(3, 32, 32)
    heading = RNG.uniform(-np.pi, np.pi, 3).astype(np.float32)
    jdepth = jnp.asarray(depth).astype(dtype)
    # jitted, as the JAX package runs it: XLA turns the divisions by
    # constants into reciprocal multiplies, which the port copies
    jx, jy, jv = jax.jit(jproj.spatial_locs, static_argnums=(1, 2),
                         static_argnames="out_hw")(
        jdepth, 20, 0.12, out_hw=(24, 24),
        heading=jnp.asarray(heading) if rotate else None)
    tdepth = _t(depth, getattr(torch, dtype))
    x, y, v = projection.spatial_locs(
        tdepth, 20, 0.12, out_hw=(24, 24),
        heading=_t(heading) if rotate else None)
    # the port reproduces JAX's dtype flow op for op: bitwise equal cells
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
