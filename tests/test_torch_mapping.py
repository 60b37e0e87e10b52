"""The port's projection and map registration vs the JAX package (CPU)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.ops import mapping as jmap
from ws_mgmap_tpu.ops import projection as jproj
from ws_mgmap_tpu_torch.ops import mapping, projection

RNG = np.random.RandomState(17)
P = dict(resolution=0.12, ego_size=10, global_size=24, map_depth=6)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _depth(b, h, w):
    d = (RNG.rand(b, h, w, 1) * 0.6).astype(np.float32)
    d[0, : h // 5] = 0.0
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_splat_to_ground_matches_jax(dtype):
    feats = RNG.randn(3, 21, 21, 5).astype(np.float32)
    depth = (RNG.rand(3, 24, 24, 1) * 8).astype(np.float32)
    x, y, v = jproj.spatial_locs(jnp.asarray(depth), 20, 0.12)
    want = jproj.splat_to_ground(jnp.asarray(feats).astype(dtype), x, y, v,
                                 20, backend="pallas")
    tx, ty, tv = projection.spatial_locs(_t(depth), 20, 0.12)
    got = projection.splat_to_ground(_t(feats).to(getattr(torch, dtype)),
                                     tx, ty, tv, 20)
    assert str(got.dtype).endswith(dtype)
    # same cells (exact binning), order-independent max: exact
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("rotate", [False, True])
def test_project_egocentric_matches_jax(rotate):
    feats = RNG.randn(2, 21, 21, 4).astype(np.float32)
    depth = _depth(2, 24, 24) * 10.0
    heading = RNG.uniform(-np.pi, np.pi, 2).astype(np.float32)
    want = jproj.project_egocentric(
        jnp.asarray(feats), jnp.asarray(depth), jnp.asarray(heading),
        ego_size=20, local_scale=0.12, rotate_coords=rotate)
    got = projection.project_egocentric(_t(feats), _t(depth), _t(heading),
                                        ego_size=20, local_scale=0.12,
                                        rotate_coords=rotate)
    # rotate-in-splat is a pure splat (exact); splat-then-rotate adds the
    # grid_sample's fp32 coordinate rounding (~1e-6 px)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _register_inputs(bs, gps):
    glob = np.abs(RNG.randn(bs, 24, 24, 6)).astype(np.float32)
    proj = RNG.randn(bs, 10, 10, 6).astype(np.float32)
    compass = RNG.uniform(-np.pi, np.pi, (bs, 1)).astype(np.float32)
    masks = np.ones((bs, 1), np.float32)
    masks[1] = 0.0
    return glob, proj, np.asarray(gps, np.float32), compass, masks


@pytest.mark.parametrize("gps", [
    [[0.0, 0.0], [1.3, -1.2], [-1.4, 1.35], [1.44, 1.44]],   # edges
    [[2.9, -2.9], [-3.1, 3.0], [0.2, -2.0], [-1.0, 0.5]],    # off the map
])
def test_register_and_retrieve_matches_jax(gps):
    glob, proj, gps, compass, masks = _register_inputs(4, gps)
    p = jmap.MapperParams(**P)
    jego, jglob = jmap.register_and_retrieve(
        jnp.asarray(glob), jnp.asarray(proj), jnp.asarray(gps),
        jnp.asarray(compass), jnp.asarray(masks), p)
    tglob = _t(glob)
    ego, out = mapping.register_and_retrieve(
        tglob, _t(proj), _t(gps), _t(compass), _t(masks),
        mapping.MapperParams(**P))
    assert out.data_ptr() == tglob.data_ptr(), "the map is updated in place"
    # the window fuse is a max (exact); the read-back rotation is
    # grid_sample vs the JAX gather in fp32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jglob))
    np.testing.assert_allclose(ego.numpy(), np.asarray(jego), rtol=1e-5,
                               atol=1e-5)


def test_episode_reset_clears_map():
    glob, proj, gps, compass, _ = _register_inputs(2, [[0, 0], [0.5, 0.5]])
    proj[:] = 0.0
    _, out = mapping.register_and_retrieve(
        _t(glob), _t(proj), _t(gps), _t(compass), torch.zeros(2, 1),
        mapping.MapperParams(**P))
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("dtype,rotate", [("float32", False),
                                          ("bfloat16", True)])
def test_rgb_mapping_step_matches_jax(dtype, rotate):
    p = dict(P, rotate_in_splat=rotate)
    bs = 2
    feat = np.abs(RNG.randn(bs, 16, 16, 6)).astype(np.float32)
    depth = _depth(bs, 32, 32)
    gps = np.array([[0.3, -0.2], [-1.1, 0.9]], np.float32)
    compass = np.array([[0.4], [-2.2]], np.float32)
    masks = np.ones((bs, 1), np.float32)
    glob = np.abs(RNG.randn(bs, 24, 24, 6)).astype(np.float32)
    if dtype == "bfloat16":
        # round the inputs once, so both start from the same bf16 values
        feat, depth, glob = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                             for a in (feat, depth, glob))
    jd = getattr(jnp, dtype)
    jego, jglob = jmap.rgb_mapping_step(
        jnp.asarray(glob).astype(jd), jnp.asarray(feat).astype(jd),
        jnp.asarray(depth).astype(jd), jnp.asarray(gps),
        jnp.asarray(compass), jnp.asarray(masks).astype(jd),
        jmap.MapperParams(**p, splat_backend="pallas"))
    td = getattr(torch, dtype)
    ego, out = mapping.rgb_mapping_step(
        _t(glob).to(td), _t(feat).to(td), _t(depth).to(td), _t(gps),
        _t(compass), _t(masks).to(td), mapping.MapperParams(**p))
    assert out.dtype == td and ego.dtype == td
    # rotate-in-splat: splat and fuse are exact. Splat-then-rotate fuses a
    # grid_sample'd projection (fp32 coordinate rounding, ~1e-6). The
    # read-back rotation is grid_sample in fp32 in both; in bf16 the port
    # rounds once where JAX blends in bf16: a few bf16 ulps of the range
    if rotate:
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(jglob, np.float32))
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(jglob), rtol=1e-5,
                                   atol=1e-5)
    atol = 1e-5 if dtype == "float32" else 4 * 2**-8 * float(
        np.abs(glob).max())
    np.testing.assert_allclose(ego.float().numpy(),
                               np.asarray(jego, np.float32), rtol=0,
                               atol=atol)


def test_unknown_splat_backend_raises():
    with pytest.raises(ValueError):
        mapping.rgb_mapping_step(
            torch.zeros(1, 24, 24, 6), torch.zeros(1, 16, 16, 6),
            torch.zeros(1, 32, 32, 1), torch.zeros(1, 2), torch.zeros(1, 1),
            torch.ones(1, 1), mapping.MapperParams(**P, splat_backend="xla"))
