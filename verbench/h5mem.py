"""An in-memory stand-in for the part of ``h5py`` that the dump uses
(after ``chip_smoke._MemoryH5``; the card's host has no ``h5py``).

Reading: ``File(path)[key][sel]`` copies ``sel`` of an array the
benchmark put under ``files[path][key]``.  Writing: ``create_dataset(name,
data, compression="gzip", compression_opts=level)`` deflates the array's
bytes with zlib at that level, as HDF5's gzip filter does, and keeps the
byte count; it keeps the array itself only for the names in ``keep`` (the
volumes the check compares).  Nothing goes to disk.  The seconds spent in
``create_dataset`` (waiting for the lock included) and the volumes
written are counted.

The library lock is part of the yardstick.  h5py serialises every call
into HDF5 under one global lock, so a deflate in one thread's
``create_dataset`` holds up every other thread's reads and writes, in
any file.  The stand-in holds one lock of the store (one store a run,
as h5py is one library a process) around each read, each write with its
whole deflate, and each lookup: a writer split over threads gains here
no more than it could under h5py.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import types
import zlib
from typing import Dict, Set

import numpy as np


class MemoryH5:
    """The store behind :meth:`module`: one per run."""

    def __init__(self):
        self.files: Dict[str, Dict[str, np.ndarray]] = {}
        self.keep: Set[str] = set()
        self.kept: Dict[str, np.ndarray] = {}
        self.written = 0
        self.deflated_bytes = 0
        self.write_s = 0.0
        self._lock = threading.Lock()
        # h5py's global lock: see the module's docstring
        self.library_lock = threading.RLock()

    def reset_counts(self):
        with self._lock:
            self.written, self.deflated_bytes, self.write_s = 0, 0, 0.0

    def module(self) -> types.SimpleNamespace:
        store = self
        lib = self.library_lock

        class Dataset:
            def __init__(self, arr):
                self.arr = arr
                self.shape, self.dtype = arr.shape, arr.dtype

            def __getitem__(self, sel):
                with lib:
                    return np.array(self.arr[sel])

            def __array__(self, dtype=None, copy=None):
                out = self[()]
                return out if dtype is None else out.astype(dtype)

        class File:
            def __init__(self, path, mode="r"):
                with lib:
                    self.data = store.files.setdefault(str(path), {})

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

            def close(self):
                pass

            def __contains__(self, key):
                with lib:
                    return key in self.data

            def __getitem__(self, key):
                with lib:
                    return Dataset(self.data[key])

            def __delitem__(self, key):
                with lib:
                    self.data.pop(key, None)

            def create_dataset(self, name, data, compression=None,
                               compression_opts=4, **_):
                t0 = time.perf_counter()
                with lib:
                    arr = np.ascontiguousarray(data)
                    n = (len(zlib.compress(arr.tobytes(),
                                           int(compression_opts)))
                         if compression == "gzip" else arr.nbytes)
                    # a marker only: the volume itself is not kept
                    self.data[name] = n
                dt = time.perf_counter() - t0
                with store._lock:
                    store.written += 1
                    store.deflated_bytes += n
                    store.write_s += dt
                    if name in store.keep:
                        store.kept[name] = arr.copy()

        return types.SimpleNamespace(File=File)

    @contextlib.contextmanager
    def installed(self):
        """``import h5py`` gives this store inside the block."""
        saved = sys.modules.get("h5py")
        sys.modules["h5py"] = self.module()
        try:
            yield self
        finally:
            if saved is None:
                sys.modules.pop("h5py", None)
            else:
                sys.modules["h5py"] = saved
