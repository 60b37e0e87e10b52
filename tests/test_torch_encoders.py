"""The port's instruction encoder and depth encoder vs the JAX package's,
with weights carried over by ``from_jax_variables``: the biLSTM features
and pad mask (a zero-length and a full-length row among them), the
GroupNorm ResNet50 depth trunk on 128^2 depth (a 2x2 output), its cached
bypass, and the layout of the spatial embeddings (a row-major reshape
of the [P, E] table, not a transpose). fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import perturb_norms
from ws_mgmap_tpu.models.depth_encoder import (
    VlnResnetDepthEncoder as JDepthEncoder)
from ws_mgmap_tpu.models.instruction_encoder import (
    InstructionEncoder as JInstructionEncoder)
from ws_mgmap_tpu_torch.models.depth_encoder import VlnResnetDepthEncoder
from ws_mgmap_tpu_torch.models.instruction_encoder import InstructionEncoder
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def _encode_both(lengths, seed: int):
    """Tokens [4, 13] with the given row lengths through both instruction
    encoders: (tokens, port features, port pad mask, JAX features, JAX
    pad mask, the time lengths the port's biLSTM was called with)."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros((4, 13), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.randint(1, 40, n)
    jmod = JInstructionEncoder(vocab_size=40, embedding_size=10,
                               hidden_size=12)
    variables = jax.tree.map(np.asarray, jmod.init(
        jax.random.PRNGKey(seed), jnp.asarray(tokens)))
    tmod = InstructionEncoder(40, 10, 12)
    sd = from_jax_variables(variables, prefixes=("",))
    assert set(sd) == set(tmod.state_dict())
    tmod.load_state_dict(sd, strict=True)
    seen = []
    tmod.encoder_rnn.register_forward_hook(
        lambda mod, args, out: seen.append(args[0].shape[1]))
    want, want_pad = jmod.apply(variables, jnp.asarray(tokens))
    with torch.no_grad():
        got, got_pad = tmod(torch.from_numpy(tokens))
    return tokens, got, got_pad, np.asarray(want), np.asarray(want_pad), seen


def test_instruction_encoder_features_and_pad_mask():
    tokens, got, got_pad, want, want_pad, _ = _encode_both(
        (5, 0, 13, 9), 4)  # a 0- and a full-length row
    assert got.shape == (4, 13, 24) and got_pad.dtype == torch.bool
    np.testing.assert_array_equal(got_pad.numpy(), want_pad)
    np.testing.assert_array_equal(got_pad.numpy(), tokens == 0)
    # same sums in the same order: a few fp32 ulps of unit-scale values
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[1], 0.0)


@pytest.mark.parametrize("lengths", [(5, 0, 9, 3), (0, 0, 0, 0)])
def test_instruction_encoder_steps_to_longest_row(lengths):
    """The biLSTM steps only as far as the longest row (one step for an
    all-pad batch); the features match JAX's at every position."""
    _, got, got_pad, want, want_pad, seen = _encode_both(lengths, 6)
    assert seen == [max(max(lengths), 1)]
    assert got.shape == (4, 13, 24)
    np.testing.assert_array_equal(got_pad.numpy(), want_pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(got.numpy()[i, n:], 0.0)


@pytest.fixture(scope="module")
def depth_pair():
    rng = np.random.RandomState(5)
    depth = rng.rand(2, 128, 128, 1).astype(np.float32)
    jmod = JDepthEncoder()
    variables = jax.tree.map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(2), jnp.asarray(depth)))
    variables = perturb_norms(variables, rng)
    tmod = VlnResnetDepthEncoder(spatial_hw=2)
    sd = from_jax_variables(variables, prefixes=("",))
    assert set(sd) == set(tmod.state_dict())
    tmod.load_state_dict(sd, strict=True)
    return jmod, variables, tmod.eval(), depth


def test_depth_encoder_trunk(depth_pair):
    jmod, variables, tmod, depth = depth_pair
    want, want_trunk = jax.jit(jmod.apply)(variables, jnp.asarray(depth))
    with torch.no_grad():
        got, got_trunk = tmod(depth=torch.from_numpy(depth))
    assert got.shape == (2, 192, 2, 2) and got_trunk.shape == (2, 2, 2, 128)
    # 54 convs with GroupNorm, summed in other orders by XLA and torch:
    # measured worst 5.4e-6 of the trunk's range
    scale = float(np.abs(want_trunk).max())
    np.testing.assert_allclose(got_trunk.numpy(), np.asarray(want_trunk),
                               rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=2e-5 * scale)


def test_depth_encoder_cached_bypass(depth_pair):
    jmod, variables, tmod, _ = depth_pair
    cached = np.random.RandomState(6).randn(3, 2, 2, 128).astype(np.float32)
    want, want_trunk = jmod.apply(variables, cached=jnp.asarray(cached))
    with torch.no_grad():
        got, got_trunk = tmod(cached=torch.from_numpy(cached))
    np.testing.assert_array_equal(got_trunk.numpy(), cached)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_spatial_embedding_layout(depth_pair):
    """Channel 128 + e at (i, j) is table entry e * h * w + i * w + j of
    the row-major [P, E] table (torch's ``view``), not table[i * w + j, e]."""
    _, _, tmod, _ = depth_pair
    table = tmod.spatial_embeddings.weight.detach().numpy()  # [4, 64]
    with torch.no_grad():
        got, _ = tmod(cached=torch.zeros(1, 2, 2, 128))
    spatial = got[0, 128:].numpy()  # [64, 2, 2]
    flat = table.reshape(-1)
    for e in (0, 1, 17, 63):
        for i in range(2):
            for j in range(2):
                assert spatial[e, i, j] == flat[e * 4 + i * 2 + j]
    assert not np.array_equal(spatial, table.T.reshape(64, 2, 2))
