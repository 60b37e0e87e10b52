"""Reusable host memory for the loader's batches.

Every array of a batch is carved out of one slab (:meth:`SlabPool.carve`).
Where CUDA is present a slab is page-locked (registered with
``cudaHostRegister``), so the update's upload is a DMA that does not block
the host; elsewhere it is plain memory, reused the same way. A new slab
holds the largest batch the pool has carved so far, not rounded up; once
a larger batch comes, the smaller slabs are retired as they come free,
so page-locking runs only while the pool grows (the first epoch, or a
new longest T).

A slab goes back to its pool once every array carved from it has been
garbage-collected (its :class:`_Lease` exports the slab's buffer, and each
array holds that export) and, for a page-locked slab, once the CUDA event
recorded at that moment on the releasing thread's current stream has
completed: the batch's copies were issued before it on that stream. So a
consumer may keep a batch as long as it likes, and the pool grows only to
the number of batches alive at once.

A slab is page-locked only while the pool's page-locked bytes stay within
half of the host's available memory (``MemAvailable`` in
``/proc/meminfo``, read when the pool grows); past that it is plain.
"""
from __future__ import annotations

import mmap
import threading
import weakref
from typing import Sequence

import numpy as np
import torch

# each array starts at a multiple of this many bytes
ALIGN = 256

# cudaHostRegisterPortable: page-locked for every CUDA context
_REGISTER_PORTABLE = 1


def mem_available() -> int:
    """The host's ``MemAvailable``, in bytes (0 where it cannot be read)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class Slab:
    """``nbytes`` of page-aligned host memory, page-locked when ``pin``
    and registration succeeds (``pinned``). ``ready``: the CUDA event the
    last batch's copies out of it complete before, or None."""

    def __init__(self, nbytes: int, pin: bool):
        self.nbytes = nbytes
        # a slab to be page-locked is faulted in by the mmap call itself,
        # which runs without the interpreter lock
        flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
        if pin:
            flags |= mmap.MAP_POPULATE
        self.bytes = np.frombuffer(mmap.mmap(-1, nbytes, flags=flags),
                                   np.uint8)
        self.pinned = pin and int(torch.cuda.cudart().cudaHostRegister(
            self.bytes.ctypes.data, nbytes, _REGISTER_PORTABLE)) == 0
        self.ready: torch.cuda.Event | None = None

    def wait(self) -> None:
        """Blocks until the copies out of the slab issued before its
        release have completed."""
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None

    def __del__(self):
        # runs before the memory is unmapped: no copy may still read it
        if getattr(self, "pinned", False):
            self.wait()
            torch.cuda.cudart().cudaHostUnregister(self.bytes.ctypes.data)


class _Lease:
    """The first ``nbytes`` of a slab, exported to the arrays of one
    batch (PEP 688); ``pool`` takes the slab back once the lease and every
    array made from it are gone."""

    def __init__(self, slab: Slab, nbytes: int, pool: "SlabPool"):
        self._view = slab.bytes[:nbytes]
        weakref.finalize(self, pool._release, slab).atexit = False

    def __buffer__(self, flags: int) -> memoryview:
        return memoryview(self._view)


class SlabPool:
    """The slabs of one loader: ``len(pool)`` of them, ``pinned_slabs``
    page-locked, holding ``pinned_bytes``. Thread-safe: the producer
    carves, any thread may release."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: list[Slab] = []
        self._largest = 0   # the most bytes a batch has needed
        self._count = 0
        self.pinned_slabs = 0
        self.pinned_bytes = 0

    def __len__(self) -> int:
        return self._count

    def carve(self, specs: Sequence[tuple[tuple[int, ...], np.dtype]]
              ) -> list[np.ndarray]:
        """Writable arrays of the given (shape, dtype), each
        :data:`ALIGN`-aligned, out of one slab of the pool."""
        return _carve(specs, self._lease)

    def _lease(self, nbytes: int) -> _Lease:
        with self._lock:
            # retired slabs are unmapped after the lock is left
            small = [s for s in self._free if s.nbytes < nbytes]
            self._largest = max(self._largest, nbytes)
            for s in small:
                self._retire(s)
            slab = next((s for s in self._free
                         if s.ready is None or s.ready.query()), None)
            if slab is None and self._free:
                slab = self._free[0]
            if slab is not None:
                self._free.remove(slab)
        if slab is None:
            slab = self._grow(self._largest)
        slab.wait()
        return _Lease(slab, nbytes, self)

    def _grow(self, nbytes: int) -> Slab:
        pin = (torch.cuda.is_available()
               and 2 * (self.pinned_bytes + nbytes) <= mem_available())
        slab = Slab(nbytes, pin)
        with self._lock:
            self._count += 1
            if slab.pinned:
                self.pinned_slabs += 1
                self.pinned_bytes += nbytes
        return slab

    def _release(self, slab: Slab) -> None:
        if slab.pinned:
            slab.ready = torch.cuda.Event()
            slab.ready.record()
        with self._lock:
            if slab.nbytes < self._largest:
                self._retire(slab)
            else:
                self._free.append(slab)

    def _retire(self, slab: Slab) -> None:
        """Forgets ``slab`` (under the lock); it is unregistered and
        unmapped when its last reference goes."""
        if slab in self._free:
            self._free.remove(slab)
        self._count -= 1
        if slab.pinned:
            self.pinned_slabs -= 1
            self.pinned_bytes -= slab.nbytes


def _carve(specs, lease) -> list[np.ndarray]:
    offsets, total = [], 0
    for shape, dtype in specs:
        total = -(-total // ALIGN) * ALIGN
        offsets.append(total)
        total += int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = lease(total)
    return [np.frombuffer(buf, dtype, int(np.prod(shape)), off).reshape(shape)
            for (shape, dtype), off in zip(specs, offsets)]


def carve(specs: Sequence[tuple[tuple[int, ...], np.dtype]]
          ) -> list[np.ndarray]:
    """:meth:`SlabPool.carve` out of fresh plain memory, with no pool."""
    return _carve(specs, lambda nbytes: np.empty(nbytes, np.uint8))
