"""The port's translation warps, registration oracle and the two pooling
ops that no rollout calls, against the JAX package (CPU).

Held:
  * ``affine_warp`` (bilinear and nearest, a resized output too),
    ``translate_norm`` and ``translate_norm_fast`` equal JAX's within
    1e-5;
  * ``register_and_retrieve_reference`` equals JAX's oracle and the
    port's own windowed ``register_and_retrieve`` within 1e-5, at the
    center, near a corner, on the boundary and fully off the map;
  * ``adaptive_avg_pool_lastdim`` and ``upsample_bilinear_x2_nhwc_blend``
    equal JAX's within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.ops import mapping as jmap
from ws_mgmap_tpu.ops import pooling as jpool
from ws_mgmap_tpu.ops import resample as jres
from ws_mgmap_tpu_torch.ops import mapping, pooling, resample

RNG = np.random.RandomState(23)
P = dict(resolution=0.12, ego_size=10, global_size=24, map_depth=6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mode,out_hw", [("bilinear", None),
                                         ("nearest", None),
                                         ("bilinear", (9, 15))])
def test_affine_warp_matches_jax(mode, out_hw):
    img = RNG.randn(3, 12, 14, 5).astype(np.float32)
    theta = (np.eye(2, 3)[None] + RNG.randn(3, 2, 3) * 0.3).astype(np.float32)
    want = jres.affine_warp(jnp.asarray(img), jnp.asarray(theta),
                            out_hw=out_hw, mode=mode)
    got = resample.affine_warp(_t(img), _t(theta), out_hw=out_hw, mode=mode)
    _close(got, want, 1e-5)


# shifts whole and fractional, past the edge, and one of an exact .5 cell
SHIFTS = [(0.0, 0.0), (0.25, -0.5), (-1.3, 0.9), (2.5, -2.5),
          (1.0 / 12, -7.0 / 12)]


@pytest.mark.parametrize("tx,ty", SHIFTS)
def test_translate_norm_matches_jax(tx, ty):
    img = RNG.randn(2, 24, 24, 4).astype(np.float32)
    txs = np.array([tx, -ty], np.float32)
    tys = np.array([ty, tx * 0.5], np.float32)
    args = (jnp.asarray(img), jnp.asarray(txs), jnp.asarray(tys))
    targs = (_t(img), _t(txs), _t(tys))
    _close(resample.translate_norm(*targs), jres.translate_norm(*args), 1e-5)
    _close(resample.translate_norm_fast(*targs),
           jres.translate_norm_fast(*args), 1e-5)
    # the stencil is the warp
    _close(resample.translate_norm_fast(*targs),
           resample.translate_norm(*targs).numpy(), 1e-5)


GPS = {
    "center_corner_edge": [[0.0, 0.0], [1.3, -1.2], [-1.4, 1.35],
                           [1.44, 1.44]],
    "off_map": [[2.9, -2.9], [-3.1, 3.0]],
}


@pytest.mark.parametrize("case", sorted(GPS))
def test_registration_oracle_matches_jax(case):
    p = mapping.MapperParams(**P)
    jp = jmap.MapperParams(**P)
    gps = np.asarray(GPS[case], np.float32)
    bs = len(gps)
    glob = np.abs(RNG.randn(bs, 24, 24, 6)).astype(np.float32)
    proj = RNG.randn(bs, 10, 10, 6).astype(np.float32)
    compass = RNG.uniform(-np.pi, np.pi, (bs, 1)).astype(np.float32)
    masks = np.ones((bs, 1), np.float32)
    masks[0] = 0.0  # one episode start: its map is cleared first
    ego_j, glob_j = jmap.register_and_retrieve_reference(
        *map(jnp.asarray, (glob, proj, gps, compass, masks)), jp)
    before = _t(glob)
    ego_r, glob_r = mapping.register_and_retrieve_reference(
        before, _t(proj), _t(gps), _t(compass), _t(masks), p)
    np.testing.assert_array_equal(before.numpy(), glob)  # left as it was
    _close(glob_r, glob_j, 1e-5)
    _close(ego_r, ego_j, 1e-5)
    ego_w, glob_w = mapping.register_and_retrieve(
        _t(glob), _t(proj), _t(gps), _t(compass), _t(masks), p)
    _close(glob_w, glob_r.numpy(), 1e-5)
    _close(ego_w, ego_r.numpy(), 1e-5)


@pytest.mark.parametrize("c,out", [(64, 1), (64, 16), (10, 4), (7, 7)])
def test_adaptive_avg_pool_lastdim_matches_jax(c, out):
    x = RNG.randn(2, 3, 5, c).astype(np.float32)
    _close(pooling.adaptive_avg_pool_lastdim(_t(x), out),
           jpool.adaptive_avg_pool_lastdim(jnp.asarray(x), out), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(7, 7), (12, 5), (1, 3)])
def test_upsample_blend_matches_jax(hw, dtype):
    x = RNG.randn(2, *hw, 3).astype(np.float32)
    want = jpool.upsample_bilinear_x2_nhwc_blend(jnp.asarray(x).astype(dtype))
    got = pooling.upsample_bilinear_x2_nhwc_blend(
        _t(x).to(getattr(torch, dtype)))
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-6)
    if dtype == "float32":  # the blend is the upsample
        _close(got, pooling.upsample_bilinear_x2_nhwc(_t(x)).numpy(), 1e-6)
