"""The port's trajectory store against the JAX package's: the same record
bytes, and a store that either package writes (native or pure-Python
backend) the other reads back exactly."""
import threading

import numpy as np
import pytest

from ws_mgmap_tpu.data import trajstore as jts
from ws_mgmap_tpu_torch.data import trajstore as ts


def make_record(rng, t, ep_id=None):
    rec = {
        "obs": {
            "rgb_features": rng.randn(t, 7, 7, 16).astype(np.float16),
            "waypoint": rng.randn(t, 2).astype(np.float32),
            "gt_semantic_map": rng.randint(0, 27, (t, 10, 10)).astype(
                np.int32),
            "vln_oracle_action_sensor": rng.randint(0, 4, (t, 1)).astype(
                np.uint8),
        },
        "prev_actions": rng.randn(t, 2).astype(np.float32),
        "oracle_actions": rng.randn(t, 2).astype(np.float32),
    }
    if ep_id is not None:
        rec["ep_id"] = np.asarray(ep_id)
    return rec


def assert_tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            assert_tree_equal(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_pack_record_matches_jax_bytes():
    rng = np.random.RandomState(1)
    for t, ep_id in ((1, None), (6, "ep-17"), (3, None)):
        rec = make_record(rng, t, ep_id)
        buf = ts.pack_record(rec)
        assert buf == jts.pack_record(rec)
        assert_tree_equal(ts.unpack_record(buf), jts.unpack_record(buf))
        assert_tree_equal(ts.unpack_record(buf), rec)
    with pytest.raises(ValueError, match="corrupt"):
        ts.unpack_record(b"XXXX" + buf[4:])


def _no_native(module, monkeypatch):
    """Force a package's store onto its pure-Python backend."""
    if module is ts:
        monkeypatch.setattr(ts, "_get_lib", lambda: None)
    else:
        monkeypatch.setattr(jts, "_lib_handle", None)
        monkeypatch.setattr(jts, "_lib_tried", True)


@pytest.mark.parametrize("reader_backend", ["native", "python"])
@pytest.mark.parametrize("writer_backend", ["native", "python"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_crosses_packages(tmp_path, monkeypatch, writer,
                                writer_backend, reader_backend):
    """Two ranks' shards written by one package, read by the other:
    records in rank order, then append order, bit for bit."""
    w_mod, r_mod = (ts, jts) if writer == "port" else (jts, ts)
    rng = np.random.RandomState(2)
    shards = [[make_record(rng, t) for t in (4, 2, 5)],
              [make_record(rng, t, "x") for t in (3, 1)]]
    d = str(tmp_path / "traj")
    with monkeypatch.context() as m:
        if writer_backend == "python":
            _no_native(w_mod, m)
        for rank in (1, 0):  # the rank order, not the write order, counts
            w = w_mod.TrajStoreWriter(d, rank=rank)
            assert (w._lib is None) == (writer_backend == "python")
            w.append_batch([w_mod.pack_record(r) for r in shards[rank][:1]])
            w.flush()
            w.append_batch([w_mod.pack_record(r) for r in shards[rank][1:]])
            w.close()
    with monkeypatch.context() as m:
        if reader_backend == "python":
            _no_native(r_mod, m)
        r = r_mod.TrajStoreReader(d)
        assert (r._lib is None) == (reader_backend == "python")
        want = shards[0] + shards[1]
        assert len(r) == len(want)
        for i, rec in enumerate(want):
            assert_tree_equal(r_mod.unpack_record(r.get(i)), rec)
        r.close()


def test_backend_and_build_location():
    """The port's library builds under build/ws_mgmap_tpu_torch/, never
    into the JAX package's build/libtrajstore.so, and readers and writers
    say which backend they use."""
    path = ts._build_lib()
    assert path is not None and path.is_file()
    assert path.parent.name == "ws_mgmap_tpu_torch"
    assert path.name.startswith("libtrajstore-")
    assert ts._get_lib() is not None


def test_concurrent_builds_never_load_a_partial_file(tmp_path, monkeypatch):
    """Builders racing on one hash each link under a temporary name and
    move the result into place: every one gets the same loadable path and
    no temporary file is left."""
    import ctypes

    monkeypatch.setattr(ts, "_BUILD_ROOT", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(ts._build_lib())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and paths[0] is not None
    ctypes.CDLL(str(paths[0])).ts_reader_count
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]


def test_backend_is_reported(tmp_path, monkeypatch):
    d = str(tmp_path / "traj")
    w = ts.TrajStoreWriter(d)
    assert w.backend == "native"
    w.close()
    assert ts.TrajStoreReader(d).backend == "native"
    monkeypatch.setattr(ts, "_get_lib", lambda: None)
    w = ts.TrajStoreWriter(d)
    assert w.backend == "python"
    w.close()
    assert ts.TrajStoreReader(d).backend == "python"
