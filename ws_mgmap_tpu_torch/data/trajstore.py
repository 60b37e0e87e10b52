"""The trajectory store (the port's copy of ``ws_mgmap_tpu/data/trajstore.py``).

Records are nested dicts of numpy arrays, packed by :func:`pack_record`
(``WSTJ``, a little-endian u32 header length, a JSON header of keys,
dtypes and shapes, then the raw buffers) and zlib-compressed into one
shard per writer rank: ``<dir>/shard_<rank>.bin`` holds the compressed
records, ``shard_<rank>.idx`` a flat array of (offset, compressed size,
raw size) as little-endian u64. The format is the JAX package's, so
either package reads what the other writes.

Compression and batched IO live in ``native/trajstore.cpp`` (a copy of
the JAX package's), built with ``g++`` on first use into
``<repo>/build/ws_mgmap_tpu_torch/``. Without a compiler or zlib's
headers the store falls back to pure Python with the same format; each
reader and writer says which it uses (``backend``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import struct
import subprocess
import tempfile
import warnings
import zlib
from pathlib import Path
from typing import Any, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "trajstore.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ws_mgmap_tpu_torch"
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def _build_lib() -> Path | None:
    """The store's shared library, keyed by a hash of the source and flags.
    It is linked under a temporary name and moved into place with
    ``os.replace``, so processes that build at once never load a partial
    file. None (and a warning) when ``g++`` or zlib is missing."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes())
    lib = _BUILD_ROOT / f"libtrajstore-{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_ROOT)
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", tmp, "-lz",
                        "-pthread"], check=True, capture_output=True)
        os.replace(tmp, lib)
        return lib
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"") or b""
        warnings.warn(f"trajstore: native build failed ({e}; "
                      f"{detail.decode(errors='replace')[-500:]}); "
                      "using the python fallback")
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def _get_lib() -> ctypes.CDLL | None:
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, argtypes, restype in (
            ("ts_writer_open", [ctypes.c_char_p, ctypes.c_int], vp),
            ("ts_writer_append_batch",
             [vp, i64, ctypes.POINTER(ctypes.c_char_p),
              ctypes.POINTER(i64), ctypes.c_int, ctypes.c_int], i64),
            ("ts_writer_flush", [vp], None),
            ("ts_writer_close", [vp], None),
            ("ts_reader_open", [ctypes.c_char_p, ctypes.c_int], vp),
            ("ts_reader_count", [vp], i64),
            ("ts_reader_raw_size", [vp, i64], i64),
            ("ts_reader_get", [vp, i64, ctypes.c_char_p, i64], i64),
            ("ts_reader_close", [vp], None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


# ---------------------------------------------------------------------------
# record (de)serialization: {'obs': {k: arr}, 'prev_actions': arr, ...}
# ---------------------------------------------------------------------------
_MAGIC = b"WSTJ"


def pack_record(tree: dict[str, Any]) -> bytes:
    """Flatten a nested dict of numpy arrays (keys sorted) into one
    buffer."""
    arrays: list[np.ndarray] = []
    meta: list[dict[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        else:
            arr = np.ascontiguousarray(node)
            meta.append({
                "key": list(prefix),
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
            })
            arrays.append(arr)

    walk(tree, ())
    header = json.dumps(meta).encode()
    parts = [_MAGIC, struct.pack("<I", len(header)), header]
    for arr in arrays:
        parts.append(arr.tobytes())
    return b"".join(parts)


def unpack_record(buf) -> dict[str, Any]:
    """The nested dict of :func:`pack_record`; the arrays are views of
    ``buf`` (any buffer: ``bytes``, or the writable ``uint8`` array that
    :meth:`TrajStoreReader.get` inflates into), read-only where it is."""
    view = memoryview(buf).cast("B")
    if view[:4] != _MAGIC:
        raise ValueError("corrupt trajstore record")
    (hlen,) = struct.unpack_from("<I", view, 4)
    meta = json.loads(bytes(view[8:8 + hlen]))
    out: dict[str, Any] = {}
    off = 8 + hlen
    for m in meta:
        dtype = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"])) if m["shape"] else 1
        arr = np.frombuffer(buf, dtype, count=count, offset=off).reshape(
            m["shape"])
        off += dtype.itemsize * count
        node = out
        for k in m["key"][:-1]:
            node = node.setdefault(k, {})
        node[m["key"][-1]] = arr
    return out


# ---------------------------------------------------------------------------
class TrajStoreWriter:
    """Appends records to this rank's shard; the native backend compresses
    a batch on ``threads`` threads."""

    def __init__(self, directory: str, rank: int = 0, level: int = 6,
                 threads: int = 8):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.rank = rank
        self.level = level
        self.threads = threads
        self._lib = _get_lib()
        if self._lib is not None:
            self._h = self._lib.ts_writer_open(directory.encode(), rank)
            if not self._h:
                self._lib = None
        if self._lib is None:
            self._bin = open(os.path.join(directory, f"shard_{rank}.bin"), "ab")
            self._idx = open(os.path.join(directory, f"shard_{rank}.idx"), "ab")
            self._off = self._bin.tell()
        self.backend = "python" if self._lib is None else "native"

    def append_batch(self, records: Sequence[bytes]) -> int:
        if not records:
            return 0
        if self._lib is not None:
            n = len(records)
            bufs = (ctypes.c_char_p * n)(*records)
            lens = (ctypes.c_int64 * n)(*[len(r) for r in records])
            wrote = self._lib.ts_writer_append_batch(
                self._h, n, bufs, lens, self.level, self.threads)
            if wrote != n:
                raise OSError(f"trajstore: short write {wrote}/{n}")
            return n
        for rec in records:
            comp = zlib.compress(rec, self.level)
            self._bin.write(comp)
            self._idx.write(struct.pack("<QQQ", self._off, len(comp), len(rec)))
            self._off += len(comp)
        return len(records)

    def flush(self):
        if self._lib is not None:
            self._lib.ts_writer_flush(self._h)
        else:
            self._bin.flush()
            self._idx.flush()

    def close(self):
        if self._lib is not None:
            self._lib.ts_writer_close(self._h)
            self._lib = None
        else:
            self._bin.close()
            self._idx.close()


class TrajStoreReader:
    """Every record of a store directory: the shards of ranks 0, 1, ...
    in turn, each in append order."""

    def __init__(self, directory: str, max_ranks: int = 64):
        self.directory = directory
        self._lib = _get_lib()
        self.backend = "python" if self._lib is None else "native"
        if self._lib is not None:
            self._h = self._lib.ts_reader_open(directory.encode(), max_ranks)
            self._count = int(self._lib.ts_reader_count(self._h))
        else:
            self._entries: list[tuple[str, int, int, int]] = []
            for rank in range(max_ranks):
                idx = os.path.join(directory, f"shard_{rank}.idx")
                if not os.path.exists(idx):
                    continue
                binp = os.path.join(directory, f"shard_{rank}.bin")
                with open(idx, "rb") as f:
                    raw = f.read()
                for i in range(len(raw) // 24):
                    off, csz, rsz = struct.unpack_from("<QQQ", raw, i * 24)
                    self._entries.append((binp, off, csz, rsz))
            self._count = len(self._entries)

    def __len__(self) -> int:
        return self._count

    def get(self, i: int) -> np.ndarray | bytes:
        """Record ``i``, inflated: a writable ``uint8`` array (native) or
        ``bytes`` (python). Either backend releases the interpreter lock
        while it inflates, and the native call opens the shard itself,
        so many threads may read at once."""
        if self._lib is not None:
            raw_size = int(self._lib.ts_reader_raw_size(self._h, i))
            if raw_size < 0:
                raise IndexError(f"trajstore: no record {i}")
            out = np.empty(raw_size, np.uint8)
            got = self._lib.ts_reader_get(
                self._h, i, out.ctypes.data_as(ctypes.c_char_p), raw_size)
            if got != raw_size:
                raise OSError(f"trajstore: reading record {i} failed ({got})")
            return out
        binp, off, csz, rsz = self._entries[i]
        with open(binp, "rb") as f:
            f.seek(off)
            comp = f.read(csz)
        return zlib.decompress(comp)

    def close(self):
        if self._lib is not None:
            self._lib.ts_reader_close(self._h)
            self._lib = None
