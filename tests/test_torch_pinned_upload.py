"""The training upload from the loader's page-locked slabs, on the card:
every leaf of a loader batch is page-locked, its non-blocking upload
equals the blocking upload of a pageable copy bit for bit, a batch kept
while later batches are built into reused slabs and uploaded stays as it
arrived, the counters read every uploaded byte as page-locked, the
pool not growing over a second epoch of the same T, and the instruction
encoder's non-blocking copy of page-locked tokens equals the blocking
one. Skipped without a card; no JAX, so it runs on the card as
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_pinned_upload.py``."""
import numpy as np
import pytest
import torch

from ws_mgmap_tpu_torch.data.trajstore import TrajStoreWriter, pack_record
from ws_mgmap_tpu_torch.models.instruction_encoder import InstructionEncoder
from ws_mgmap_tpu_torch.models.policy import MGMapConfig
from ws_mgmap_tpu_torch.tools.synthetic import train_episodes
from ws_mgmap_tpu_torch.train import replay, step

pytestmark = pytest.mark.gpu

# 16 episodes of at most 16 steps: 8 batches of 2 an epoch, each at T=16
LENGTHS = (5, 3, 9, 4, 7, 2, 6, 8, 16, 5, 10, 12, 3, 11, 6, 9)
SMALL = MGMapConfig(vocab_size=50, ego_map_size=20, map_depth=8,
                    unet_width=0.125, depth_spatial=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked memory and the "
                    "non-blocking upload exist only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pinned") / "store")
    w = TrajStoreWriter(d)
    w.append_batch([pack_record(e) for e in train_episodes(
        np.random.RandomState(7), LENGTHS, SMALL)])
    w.close()
    return d


def _leaves(batch: dict) -> dict:
    out = {k: v for k, v in batch.items() if k != "obs"}
    out.update({f"obs.{k}": v for k, v in batch["obs"].items()})
    return out


def _copy(batch: dict) -> dict:
    out = {k: np.copy(v) for k, v in batch.items() if k != "obs"}
    out["obs"] = {k: np.copy(v) for k, v in batch["obs"].items()}
    return out


def _assert_uploads_equal(got: dict, want: dict) -> None:
    torch.cuda.synchronize()
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device == want[k].device, k
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def test_loader_batches_are_page_locked(cuda, store):
    loader = replay.ReplayLoader(store, batch_size=2, max_len=200, seed=3)
    batch = next(iter(loader))
    for k, leaf in _leaves(batch).items():
        assert torch.from_numpy(leaf).is_pinned(), k
    assert loader.pinned_slabs >= 1 and loader.pinned_bytes > 0


def test_pinned_upload_equals_pageable(cuda, store):
    loader = replay.ReplayLoader(store, batch_size=2, max_len=200, seed=3)
    for batch in loader:
        pageable = _copy(batch)
        assert not torch.from_numpy(pageable["weights"]).is_pinned()
        _assert_uploads_equal(step.upload_batch(batch, cuda),
                              step.upload_batch(pageable, cuda))


def test_kept_batch_survives_later_batches(cuda, store):
    """The first batch is kept while 6 more are built into the pool's
    slabs and uploaded, each dropped at once."""
    loader = replay.ReplayLoader(store, batch_size=2, max_len=200, seed=3)
    it = iter(loader)
    kept = next(it)
    at_arrival = _copy(kept)
    first = step.upload_batch(kept, cuda)
    for _ in range(6):
        step.upload_batch(next(it), cuda)
    it.close()
    torch.cuda.synchronize()
    for k, leaf in _leaves(at_arrival).items():
        np.testing.assert_array_equal(_leaves(kept)[k], leaf, err_msg=k)
    _assert_uploads_equal(first, step.upload_batch(at_arrival, cuda))


def test_counters_read_every_byte_pinned(cuda, store):
    loader = replay.ReplayLoader(store, batch_size=2, max_len=200, seed=3)
    for batch in loader:
        step.upload_batch(batch, cuda)
    slabs, nbytes = loader.pinned_slabs, loader.pinned_bytes
    pinned0, pageable0 = (step.upload_batch.pinned_bytes,
                          step.upload_batch.pageable_bytes)
    uploaded = 0
    for batch in loader:
        assert batch["weights"].shape[1] == 16
        step.upload_batch(batch, cuda)
        uploaded += sum(v.nbytes for k, v in _leaves(batch).items()
                        if k != "obs.instruction")
    torch.cuda.synchronize()
    assert step.upload_batch.pageable_bytes == pageable0
    assert step.upload_batch.pinned_bytes - pinned0 == uploaded > 0
    assert (loader.pinned_slabs, loader.pinned_bytes) == (slabs, nbytes)
    assert 1 <= slabs <= 2 + 2


def test_encoder_reads_pinned_tokens_as_pageable(cuda, store):
    """The instruction encoder's non-blocking copy of page-locked tokens
    (a loader batch's, flattened as ``MGMapNet.seq`` does) gives what the
    blocking copy of a pageable copy gives, bit for bit."""
    torch.manual_seed(0)
    enc = InstructionEncoder(vocab_size=50, embedding_size=8,
                             hidden_size=16).to(cuda)
    loader = replay.ReplayLoader(store, batch_size=2, max_len=200, seed=3)
    batch = next(iter(loader))
    tok = torch.from_numpy(batch["obs"]["instruction"])
    tok = tok.reshape(-1, tok.shape[-1])
    assert tok.is_pinned()
    with torch.no_grad():
        got = enc(tok)
        want = enc(tok.clone())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
