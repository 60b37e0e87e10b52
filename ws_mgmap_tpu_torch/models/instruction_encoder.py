"""Instruction encoder: word embedding + bidirectional LSTM.

Port of ``ws_mgmap_tpu/models/instruction_encoder.py``: embeddings (vocab
2504 x 50) feed a one-layer biLSTM (50 -> 128 each way); the result is
per-token features [B, T, 256] and a padding mask, True at pads. Token
id 0 is the pad, and a row's length is its count of non-zero tokens.
``load_pretrained_embeddings`` reads the dataset's embedding table.
"""
from __future__ import annotations

import gzip
import json

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ws_mgmap_tpu_torch.models.rnn import TorchBiLSTM


def load_pretrained_embeddings(path: str) -> np.ndarray:
    """The dataset's ``embeddings.json.gz`` (reference `:55-66`) as a
    float32 [vocab, embedding_size] array, for
    ``embedding_layer.weight``."""
    with gzip.open(path, "rt") as f:
        return np.asarray(json.load(f), dtype=np.float32)


class InstructionEncoder(nn.Module):
    def __init__(self, vocab_size: int = 2504, embedding_size: int = 50,
                 hidden_size: int = 128):
        super().__init__()
        # torch's default Embedding init is N(0, 1), the JAX package's too
        self.embedding_layer = nn.Embedding(vocab_size, embedding_size)
        self.encoder_rnn = TorchBiLSTM(embedding_size, hidden_size)

    @property
    def output_size(self) -> int:
        return 2 * self.encoder_rnn.hidden_size

    def forward(self, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, T] int -> (features [B, T, 2H], pad_mask [B, T]) on
        the module's device. The biLSTM steps only as far as the longest
        row (past it every row's output is zero); that length is read
        where the tokens lie, so tokens on the host cost the card no
        sync. Tokens in page-locked memory (a training batch from the
        loader's slabs) go to the card without blocking the host: a
        blocking copy would wait for the batch's upload queued before
        it."""
        lengths = (tokens != 0).sum(1)
        t, steps = tokens.shape[1], max(int(lengths.max()), 1)
        device = self.embedding_layer.weight.device
        pinned = device.type != "cpu" and tokens.is_pinned()
        if pinned:
            lengths = lengths.pin_memory()
        tokens = tokens.to(device, non_blocking=pinned)
        lengths = lengths.to(device, non_blocking=pinned)
        out = self.encoder_rnn(self.embedding_layer(tokens[:, :steps]),
                               lengths)
        out = F.pad(out, (0, 0, 0, t - steps))
        pos = torch.arange(t, device=device)
        return out, pos[None, :] >= lengths[:, None]
