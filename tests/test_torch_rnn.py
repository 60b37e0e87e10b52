"""The port's recurrent cells vs the JAX package's: the mask-gated GRU step
and the biLSTM with packed-sequence semantics (ragged lengths, a length
of 0, the full length), with weights carried over by
``from_jax_variables``. fp32; the two compute the same sums in the same
order, so the tolerance is a few fp32 ulps of the unit-scale outputs."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.models.rnn import RNNStateEncoder as JStateEncoder
from ws_mgmap_tpu.models.rnn import TorchBiLSTM as JBiLSTM
from ws_mgmap_tpu_torch.models.rnn import RNNStateEncoder, TorchBiLSTM
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def _carry(jmod, tmod, *args):
    variables = jax.tree.map(np.asarray,
                             jmod.init(jax.random.PRNGKey(3), *args))
    tmod.load_state_dict(from_jax_variables(variables, prefixes=("",)),
                         strict=True)
    return variables


def test_gru_step_with_mask_reset():
    rng = np.random.RandomState(0)
    b, i, h = 4, 12, 16
    x = rng.randn(b, i).astype(np.float32)
    h0 = rng.randn(b, h).astype(np.float32)
    masks = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)
    jmod, tmod = JStateEncoder(i, h), RNNStateEncoder(i, h)
    variables = _carry(jmod, tmod, x, h0, masks)
    assert set(tmod.state_dict()) == {f"rnn.{n}_l0" for n in (
        "weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    want, want_h = jmod.apply(variables, x, h0, masks)
    got, got_h = tmod(torch.from_numpy(x), torch.from_numpy(h0),
                      torch.from_numpy(masks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               **TOL)
    # a reset row is the cell from a zero state: the same as a fresh step
    fresh, _ = tmod(torch.from_numpy(x), torch.zeros(b, h),
                    torch.ones(b, 1))
    np.testing.assert_array_equal(got.detach().numpy()[1],
                                  fresh.detach().numpy()[1])


@pytest.fixture(scope="module")
def bilstm():
    rng = np.random.RandomState(1)
    b, t, i, h = 5, 11, 6, 8
    xs = rng.randn(b, t, i).astype(np.float32)
    lengths = np.array([3, 0, 11, 7, 1], np.int32)  # ragged, 0 and full
    jmod, tmod = JBiLSTM(i, h), TorchBiLSTM(i, h)
    variables = _carry(jmod, tmod, xs, lengths)
    want = np.asarray(jmod.apply(variables, jnp.asarray(xs),
                                 jnp.asarray(lengths)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(xs), torch.from_numpy(lengths)).numpy()
    return tmod, xs, lengths, want, got


def test_bilstm_ragged_lengths_vs_jax(bilstm):
    _, _, lengths, want, got = bilstm
    assert got.shape == want.shape == (5, 11, 16)
    np.testing.assert_allclose(got, want, **TOL)
    for row, n in enumerate(lengths):  # zeros past each length
        assert not got[row, n:].any()
        assert n == 0 or np.abs(got[row, :n]).min() > 0


def test_bilstm_zero_length_row_is_zero(bilstm):
    _, _, lengths, want, got = bilstm
    assert lengths[1] == 0
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(want[1], 0.0)


def test_bilstm_matches_torch_packed_lstm(bilstm):
    """The non-empty rows against torch's own ``nn.LSTM`` over a packed
    sequence with the same weights (pack_padded_sequence cannot hold the
    length-0 row)."""
    tmod, xs, lengths, _, got = bilstm
    lstm = torch.nn.LSTM(xs.shape[-1], tmod.hidden_size, batch_first=True,
                         bidirectional=True)
    lstm.load_state_dict(tmod.state_dict(), strict=True)
    rows = np.flatnonzero(lengths > 0)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.from_numpy(xs[rows]), torch.from_numpy(lengths[rows]).long(),
        batch_first=True, enforce_sorted=False)
    with torch.no_grad():
        ref, _ = torch.nn.utils.rnn.pad_packed_sequence(
            lstm(packed)[0], batch_first=True, total_length=xs.shape[1])
    np.testing.assert_allclose(got[rows], ref.numpy(), **TOL)


def test_bilstm_runs_in_bf16(bilstm):
    """The engine casts every weight to bf16: the cells take it, and stay
    within bf16 rounding of the fp32 result."""
    tmod, xs, lengths, _, got = bilstm
    with torch.no_grad():
        out = copy.deepcopy(tmod).to(torch.bfloat16)(
            torch.from_numpy(xs).bfloat16(), torch.from_numpy(lengths))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), got, rtol=0, atol=0.05)
