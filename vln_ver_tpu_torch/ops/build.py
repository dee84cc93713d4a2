"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``vln_ver_tpu_torch/csrc/*.cu`` compiles on its own into a shared
library with a plain C interface under ``.kernel_build/`` at the checkout's
root (listed in ``.gitignore``).  A library's file name carries a hash of
its source, the shared headers ``csrc/*.cuh`` and the flags, so a changed
source or header rebuilds and an unchanged one is reused.  Nothing here runs at import time.

:class:`CudaKernel` binds one library's C entry point and launches it on
the current stream; each kernel module subclasses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _lib_path(src: Path) -> Path:
    # every header of csrc/ goes into every library's hash: an edited header
    # rebuilds each source that may include it
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once (one
    ``nvcc`` per source).  Returns {source stem: library path}.  The
    compiler's output, ``-Xptxas -v`` register and shared-memory report
    included, is kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: _lib_path(src) for src in sorted(CSRC.glob("*.cu"))}
    procs = []
    for stem, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".so.log"), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs.append((lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{lib.name} (nvcc rc={rc}):\n"
                          + lib.with_suffix(".so.log").read_text())
        else:
            os.replace(tmp, lib)   # atomic: a concurrent process never
            # loads a half-written library
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return libs


def load_library(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<stem>.cu``."""
    return ctypes.CDLL(str(build_all()[stem]))


_SM_COUNT: Dict[int, int] = {}


def sm_count(device) -> int:
    """The multiprocessor count of the CUDA ``device``, read once."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


CUDA_ERROR_INVALID_VALUE = 1


class CudaKernel:
    """One ctypes-bound kernel: loads its library at first use, launches
    on the device's current stream, raises on a CUDA error and counts its
    host launches in ``launches``.  A launch recorded into a CUDA graph
    counts once, when it is captured; the graph's replays launch nothing
    from the host and count nothing here (a ``utils.cuda_graph.GraphCache``
    counts them as ``<name>#graph_replays`` in the recorder).  Subclasses
    name the library, the C entry point and its arguments' types, and
    marshal the arguments."""

    library = symbol = ""
    argtypes: list = []
    # what the entry point refuses with cudaErrorInvalidValue, where it
    # is the only check of it: raised as a ValueError that says so
    refuses = ""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launch(self, device, *args) -> None:
        """Call the entry point with ``args`` and the device's current
        stream; raise on a CUDA error, else count the launch."""
        if self._fn is None:
            fn = getattr(load_library(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err == CUDA_ERROR_INVALID_VALUE and self.refuses:
            raise ValueError(f"{self.symbol} refused its arguments: "
                             f"{self.refuses}")
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
