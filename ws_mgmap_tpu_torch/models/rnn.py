"""Recurrent cells with torch parameter layout, written as plain tensor ops.

Port of ``ws_mgmap_tpu/models/rnn.py``: the instruction biLSTM with
``pack_padded_sequence`` semantics, the mask-gated GRU of habitat's
``RNNStateEncoder``, and the stacked LSTM of the DD-PPO controller.
Parameters keep torch's names and layout (``weight_ih_l0`` [G*H, I],
``weight_hh_l0`` [G*H, H], ``bias_*_l0`` [G*H], plus ``_reverse``
variants), gate order GRU (r, z, n) and LSTM (i, f, g, o), so a
reference checkpoint loads by key.

The cells are plain tensor ops on the CPU and the card alike, in any
floating dtype: the rollout engine runs them in bf16, which cuDNN's RNN
does not take, and a packed sequence cannot hold a length of 0, which an
all-pad instruction row has (its output is zeros here, as in JAX).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn


def _uniform_(hidden: int, *params: nn.Parameter) -> None:
    """torch's RNN init: U(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / math.sqrt(hidden)
    with torch.no_grad():
        for p in params:
            p.uniform_(-bound, bound)


def gru_cell(x: torch.Tensor, h: torch.Tensor, w_ih: torch.Tensor,
             w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor
             ) -> torch.Tensor:
    """torch GRUCell math; x [B, I], h [B, H], weights [3H, *] (r, z, n)."""
    gi = nn.functional.linear(x, w_ih, b_ih)
    gh = nn.functional.linear(h, w_hh, b_hh)
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
              b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """torch LSTMCell math, gates (i, f, g, o). x [..., B, I], h and c
    [..., B, H], weights [..., 4H, *], biases [..., 4H]: a leading
    dimension runs several cells (the two directions) in one call."""
    g = (x @ w_ih.transpose(-1, -2) + b_ih.unsqueeze(-2)
         + h @ w_hh.transpose(-1, -2) + b_hh.unsqueeze(-2))
    i, f, gg, o = g.chunk(4, -1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


class TorchGRU(nn.Module):
    """Single-layer GRU with torch parameters: one masked step a call, or
    a sequence (``seq``)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        g = 3 * hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.empty(g, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(g, hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.empty(g))
        self.bias_hh_l0 = nn.Parameter(torch.empty(g))
        _uniform_(hidden_size, *self.parameters())

    def forward(self, x: torch.Tensor, h: torch.Tensor, mask: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """h' = cell(x, h * mask); x [B, I], h [B, H], mask [B, 1] (0 at
        an episode start). Returns (h', h')."""
        h = gru_cell(x, h * mask.reshape(-1, 1), self.weight_ih_l0,
                     self.weight_hh_l0, self.bias_ih_l0, self.bias_hh_l0)
        return h, h

    def seq(self, xs: torch.Tensor, h0: torch.Tensor, masks: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """The masked step over time: xs [T, B, I], h0 [B, H], masks
        [T, B, 1] -> (outputs [T, B, H], h_T)."""
        h, ys = h0, []
        for x, m in zip(xs, masks):
            h, _ = self(x, h, m)
            ys.append(h)
        return torch.stack(ys), h


class TorchBiLSTM(nn.Module):
    """Single-layer bidirectional LSTM with ``pack_padded_sequence``
    semantics: at t < length the output is [fwd_h_t ; bwd_h_t], the
    backward pass starting at each row's last real token; at t >= length
    it is zero, and a row of length 0 is all zeros."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        g = 4 * hidden_size
        for sfx in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{sfx}",
                                    nn.Parameter(torch.empty(g, input_size)))
            self.register_parameter(f"weight_hh_l0{sfx}",
                                    nn.Parameter(torch.empty(g, hidden_size)))
            self.register_parameter(f"bias_ih_l0{sfx}",
                                    nn.Parameter(torch.empty(g)))
            self.register_parameter(f"bias_hh_l0{sfx}",
                                    nn.Parameter(torch.empty(g)))
        _uniform_(hidden_size, *self.parameters())

    def _both(self, name: str) -> torch.Tensor:
        """A parameter of both directions stacked: [2, ...]."""
        return torch.stack([getattr(self, name),
                            getattr(self, name + "_reverse")])

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        """xs [B, T, I], lengths [B] -> [B, T, 2H]. Both directions step
        together; each row's state stays frozen past its length."""
        b, t, i = xs.shape
        steps = torch.arange(t, device=xs.device)
        step_mask = steps[None, :] < lengths[:, None]  # [B, T]
        # the backward direction reads each row's real prefix reversed:
        # rev[t] = x[len - 1 - t], clipped into range
        idx = (lengths[:, None] - 1 - steps[None, :]).clamp(0, t - 1)
        xs_rev = xs.gather(1, idx[..., None].expand(b, t, i))
        x2 = torch.stack([xs, xs_rev])  # [2, B, T, I]
        w_ih, w_hh = self._both("weight_ih_l0"), self._both("weight_hh_l0")
        b_ih, b_hh = self._both("bias_ih_l0"), self._both("bias_hh_l0")
        h = xs.new_zeros(2, b, self.hidden_size)
        c = torch.zeros_like(h)
        outs = []
        # unbind, not x2[:, :, k]: its backward is one stack where each
        # indexing's would write a full-size zero gradient per step
        for k, x in enumerate(x2.unbind(2)):
            h_new, c_new = lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh)
            m = step_mask[:, k, None]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            outs.append(h_new)
        ys = torch.stack(outs, 2)  # [2, B, T, H]
        bwd = ys[1].gather(1, idx[..., None].expand(b, t, self.hidden_size))
        out = torch.cat([ys[0], bwd], -1)
        return torch.where(step_mask[..., None], out, out.new_zeros(()))


class RNNStateEncoder(nn.Module):
    """habitat's ``RNNStateEncoder`` (one GRU layer, mask-gated hidden
    state); the GRU sits under ``rnn`` as in habitat's keys."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.rnn = TorchGRU(input_size, hidden_size)

    def forward(self, x: torch.Tensor, h: torch.Tensor, masks: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        return self.rnn(x, h, masks)

    def seq(self, xs: torch.Tensor, h0: torch.Tensor, masks: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
        return self.rnn.seq(xs, h0, masks)


class StackedLSTM(nn.Module):
    """A multi-layer ``nn.LSTM`` stepped once, with its parameters
    (``weight_ih_l{k}``, ...): the DD-PPO controller's state encoder."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        g = 4 * hidden_size
        for k in range(num_layers):
            i = input_size if k == 0 else hidden_size
            self.register_parameter(f"weight_ih_l{k}",
                                    nn.Parameter(torch.empty(g, i)))
            self.register_parameter(f"weight_hh_l{k}",
                                    nn.Parameter(torch.empty(g, hidden_size)))
            self.register_parameter(f"bias_ih_l{k}",
                                    nn.Parameter(torch.empty(g)))
            self.register_parameter(f"bias_hh_l{k}",
                                    nn.Parameter(torch.empty(g)))
        _uniform_(hidden_size, *self.parameters())

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, I], h and c [num_layers, B, H] -> (the last layer's
        output [B, H], new h, new c)."""
        hs, cs = [], []
        for k in range(self.num_layers):
            x, ck = lstm_cell(x, h[k], c[k], getattr(self, f"weight_ih_l{k}"),
                              getattr(self, f"weight_hh_l{k}"),
                              getattr(self, f"bias_ih_l{k}"),
                              getattr(self, f"bias_hh_l{k}"))
            hs.append(x)
            cs.append(ck)
        return x, torch.stack(hs), torch.stack(cs)
