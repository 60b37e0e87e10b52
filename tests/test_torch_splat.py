"""The splat kernel's plain twin vs the JAX Pallas splat kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX
package's own tests run them. A max picks one of its inputs and both
accumulate in fp32, so every comparison is exact. The CUDA kernel is held
against the twin in test_torch_kernels.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.ops.pallas.splat import splat_pallas, splat_pallas_packed
from ws_mgmap_tpu_torch.ops.kernels import splat as ksplat
from ws_mgmap_tpu_torch.tools.synthetic import special_splat_inputs

RNG = np.random.RandomState(5)
EGO = 12


def _inputs(b, p, c, invalid=0.75, dtype=np.float32):
    """Signed features and ids with ~75% invalid pixels, the valid ones
    crowded onto a few cells as near the agent."""
    feats = (RNG.randn(b, p, c) * 2.0).astype(dtype)
    ids = RNG.randint(0, EGO * EGO, (b, p)).astype(np.int32)
    crowd = RNG.rand(b, p) < 0.3
    ids[crowd] = RNG.randint(0, 6, crowd.sum())
    ids[RNG.rand(b, p) < invalid] = -1
    return feats, ids


def _twin(feats, ids):
    t = torch.from_numpy(np.asarray(feats, np.float32))
    if feats.dtype == ml_dtypes.bfloat16:
        t = t.to(torch.bfloat16)
    return ksplat.splat_max(t, torch.from_numpy(ids), EGO).numpy()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_twin_matches_splat_pallas_b2(dtype):
    feats, ids = _inputs(2, 1500, 8, dtype=dtype)
    want = np.asarray(splat_pallas(jnp.asarray(feats), jnp.asarray(ids),
                                   ego_size=EGO))
    got = _twin(feats, ids)
    assert (got < 0).any(), "negative valid maxima must survive"
    assert (got == 0).any(), "untouched cells must be 0"
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_twin_matches_splat_pallas_packed_b13(dtype):
    # B=13 has no divisor in [2, 6]: the JAX package's packed kernel
    feats, ids = _inputs(13, 600, 8, dtype=dtype)
    want = np.asarray(splat_pallas_packed(jnp.asarray(feats),
                                          jnp.asarray(ids), ego_size=EGO))
    np.testing.assert_array_equal(_twin(feats, ids), want)



@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_twin_matches_splat_pallas_on_edge_values(dtype):
    """NaN (of either sign), +inf, +0.0 beside -0.0, maxima at or below
    -1e16, -inf and an all-invalid frame: both propagate NaN and write 0
    at empty cells and maxima <= -1e16. The sign of a zero max taken over
    +0.0 and -0.0 depends on the order of the merges; assert_array_equal
    compares NaN positions and treats +0.0 and -0.0 as equal."""
    feats, ids = special_splat_inputs(np.random.RandomState(3), 256, 4, EGO)
    feats = feats.astype(dtype)
    want = np.asarray(splat_pallas(jnp.asarray(feats), jnp.asarray(ids),
                                   ego_size=EGO))
    got = _twin(feats, ids)
    cell = got.reshape(2, EGO * EGO, 4)
    assert np.isnan(cell[0, 0, 0]) and np.isnan(cell[0, 1, 1])
    assert cell[0, 2, 2] == np.inf
    # (cell 7 holds -1e16, which bf16 rounds to -9.99e15)
    assert (cell[0, 5:7] == 0).all() and (cell[1] == 0).all()
    np.testing.assert_array_equal(got, want)
