"""VER volume dump — the product path (PyTorch port of
``vln_ver_tpu/ver_writer.py``).

:func:`dump_volumes` runs the lift over a dataset and writes each volume
into an HDF5 file with ``key = token``, fp32 ``(C, Z, H, W)``, gzip: the
reference dump schema (voxelformer_occupancy_head.py:627-638).  The stages
overlap:

* the dataset iterator prefetches HDF5 reads on its own thread;
* a transfer thread casts (or quantises to int8) and uploads batch k+1
  while batch k computes;
* batch k's result is copied to pinned host memory behind an event, so
  batch k+1 is queued on the card before the host waits for batch k;
* gzip + HDF5 writes run on a writer thread that alone owns the output
  file (h5py has no concurrent writers), bounded by a small queue.

``serial=True`` keeps the naive loop as the oracle; both write identical
bytes.
"""

from __future__ import annotations

import contextlib
import queue as queue_mod
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .utils.profiling import span

_CASTS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def quantize_int8(feats):
    """Symmetric int8 quantisation of a (B, cams, fh, fw, C) feature batch
    per (sample, camera, channel), the port's copy of
    ``vln_ver_tpu/ver_writer.py:quantize_int8``: ``scale = absmax / 127``
    over the spatial axes; returns ``(q int8, scale fp32)`` with ``scale``
    shaped (B, cams, 1, 1, C).  |f - q * scale| <= absmax / 254 within each
    (camera, channel) slab."""
    f = np.asarray(feats, dtype=np.float32)
    absmax = np.max(np.abs(f), axis=(2, 3), keepdims=True)
    scale = (np.maximum(absmax, 1e-12) / 127.0).astype(np.float32)
    q = np.clip(np.rint(f / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """The features of :func:`quantize_int8`, on ``q``'s device: the
    product in fp32 (the scales' precision), then the compute dtype."""
    return (q.float() * scale).to(dtype)


def _upload_cast(ver, input_cast="auto", input_key: str = "features"):
    """What :func:`dump_volumes` does to a batch's ``input_key`` before the
    upload: ``"int8"`` (quantise), a torch dtype (cast) or None (upload as
    it is).  ``"auto"`` is the model's compute dtype where it is narrower
    than fp32, else None; ``"float32"`` and ``"bfloat16"`` name the dtype;
    None uploads as it is.  uint8 images take only ``"auto"`` or None: they
    are already the smallest exact payload."""
    if input_key == "images":
        if input_cast not in (None, "auto"):
            raise ValueError(
                f"input_cast={input_cast!r} is a feature-upload option; "
                "the image path uploads uint8 (exact) already")
        return None
    if input_key != "features":
        raise ValueError(f"input_key must be 'features' or 'images', got "
                         f"{input_key!r}")
    if input_cast == "auto":
        return ver.dtype if ver.dtype.itemsize < 4 else None
    if input_cast is None or input_cast == "int8":
        return input_cast
    if input_cast not in _CASTS:
        raise ValueError(f"input_cast must be 'auto', None, 'float32', "
                         f"'bfloat16' or 'int8', got {input_cast!r}")
    return _CASTS[input_cast]


def volumes_from_bev(bev: np.ndarray, ver) -> np.ndarray:
    """(B, bev_num, C) voxel embeddings -> (B, C, Z, H, W) contiguous fp32,
    the dump layout of the reference (head:634-636)."""
    b = bev.shape[0]
    vol = np.asarray(bev).reshape(b, ver.bev_z, ver.bev_h, ver.bev_w,
                                  ver.embed_dims).transpose(0, 4, 1, 2, 3)
    return np.ascontiguousarray(vol, dtype=np.float32)


@span("ver_writer#dump", device=False)
def dump_volumes(bev_only: Callable, dataset, ver, savename: str,
                 batch_size: int = 1, gzip_level: int = 4,
                 serial: bool = False,
                 indices: Optional[Sequence[int]] = None,
                 device="cuda", input_cast="auto", mesh=None,
                 input_key: str = "features") -> dict:
    """Run ``bev_only(inputs, w2p, shift) -> (bev, overflow)`` on
    ``device`` over ``dataset`` and write each volume to ``savename``
    (HDF5, key=token, gzip at ``gzip_level``; an existing key is
    replaced).

    ``input_key`` is the batch entry fed as ``inputs``: ``"features"``
    (precomputed ViT features) or ``"images"`` (raw uint8 views, for a
    ``bev_only`` that runs the ViT frontend and the lift in one call).
    ``input_cast`` is what happens to them before the upload
    (:func:`_upload_cast`): ``"auto"`` casts features to the model's
    compute dtype where it is narrower than fp32 (the model's first touch
    of them is that cast anyway), ``"float32"`` / ``"bfloat16"`` cast to
    that dtype, None uploads as it is, and ``"int8"`` uploads
    :func:`quantize_int8`'s int8 values and fp32 scales and dequantises
    on the device before ``bev_only`` (not exact).

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank calls this function)
    splits ``indices`` over the data ranks in contiguous blocks
    (``multihost.shard_indices``), each taking batches of ``batch_size /
    D`` viewpoints (``batch_size`` must divide by D, as in JAX), and hands
    ``bev_only`` this rank's block of cameras: the model behind it must
    split its lift the same way (``VoxelFormer.shard_views(mesh.views)``).
    Only view rank 0 of a data group writes (HDF5 has no concurrent
    writers: the caller gives each data group its own ``savename``), and
    ``sca_overflow`` is the world's largest.

    Returns ``dict(written, seconds, volumes_per_sec, sca_overflow)``;
    the caller decides what a nonzero overflow means.
    """
    from .data.mp3d import iterate_batches

    cast = _upload_cast(ver, input_cast, input_key)
    device = torch.device(device)
    writes = True
    if mesh is not None:
        from .parallel.mesh import shard_views
        from .parallel.multihost import shard_indices
        if batch_size % mesh.data_size:
            raise ValueError(f"batch_size {batch_size} not divisible by the "
                             f"mesh's data size {mesh.data_size}")
        batch_size //= mesh.data_size
        idx = list(indices if indices is not None else range(len(dataset)))
        indices = [idx[i] for i in shard_indices(len(idx), mesh.data_index,
                                                 mesh.data_size)]
        writes = mesh.writer
    if writes:
        import h5py

    write_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=4)
    werr: list = []
    written = 0

    def _write(outf, tokens, vol):
        nonlocal written
        if not writes:
            return
        for i, token in enumerate(tokens):
            with span("ver_writer#write", device=False):
                if token in outf:
                    del outf[token]
                outf.create_dataset(token, data=vol[i], compression="gzip",
                                    compression_opts=gzip_level)
            written += 1

    def open_out():
        if not writes:
            return contextlib.nullcontext()
        return h5py.File(savename, "a")

    def writer():
        try:
            with open_out() as outf:
                while True:
                    item = write_q.get()
                    if item is None:
                        return
                    _write(outf, *item)
        except BaseException as e:
            werr.append(e)
            while True:   # drain so the producer never blocks on put()
                try:
                    if write_q.get_nowait() is None:
                        return
                except queue_mod.Empty:
                    return

    @span("ver_writer#prep", device=False)
    def prep(batch):
        """Cast or quantise and upload one batch (on the transfer thread
        when pipelined)."""
        if mesh is not None:
            batch = shard_views(mesh, batch)
        if cast == "int8":
            inputs = tuple(torch.from_numpy(a).to(device)
                           for a in quantize_int8(batch[input_key]))
        else:
            x = torch.from_numpy(np.asarray(batch[input_key]))
            inputs = ((x if cast is None else x.to(cast)).to(device),)
        args = (*inputs,
                torch.from_numpy(np.asarray(batch["world2pixel"])).to(device),
                torch.from_numpy(np.asarray(batch["origin_shift"])).to(device))
        return args, list(batch["token"])

    @span("ver_writer#dispatch")
    def dispatch(args, tokens):
        """Queue the lift and the copy of its result to the host; returns
        (host tensor, event or None, tokens, overflow)."""
        if cast == "int8":
            q, scale, *args = args
            args = (dequantize_int8(q, scale, ver.dtype), *args)
        bev, ovf = bev_only(*args)
        bev = bev.float()
        if bev.is_cuda:
            host = torch.empty(bev.shape, dtype=bev.dtype, pin_memory=True)
            host.copy_(bev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = bev, None
        return host, done, tokens, ovf

    @span("ver_writer#fetch", device=False)
    def fetch_vol(pending):
        host, done, tokens, _ = pending
        if done is not None:
            done.synchronize()
        return tokens, volumes_from_bev(host.numpy(), ver)

    def fetch_and_enqueue(pending):
        tokens, vol = fetch_vol(pending)
        if werr:
            raise RuntimeError("HDF5 writer failed") from werr[0]
        with span("ver_writer#enqueue", device=False):
            write_q.put((tokens, vol))

    @span("ver_writer#next", device=False)
    def next_batch(it):
        return next(it, None)

    wt = None
    if not serial:
        wt = threading.Thread(target=writer, daemon=True)
        wt.start()

    t0 = time.perf_counter()
    overflows = []   # read once at the end: no sync per batch
    pending = None
    serial_file = h5py.File(savename, "a") if serial and writes else None
    transfer = None if serial else ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="ver_transfer")
    try:
        it = iterate_batches(dataset, batch_size, indices=indices)
        staged = None  # future of the next prepared batch
        while True:
            if serial:
                batch = next_batch(it)
                if batch is None:
                    break
                args, tokens = prep(batch)
            else:
                if staged is None:
                    batch = next_batch(it)
                    if batch is None:
                        break
                    staged = transfer.submit(prep, batch)
                with span("ver_writer#wait_prep", device=False):
                    args, tokens = staged.result()
                nxt = next_batch(it)
                staged = (transfer.submit(prep, nxt)
                          if nxt is not None else None)
            item = dispatch(args, tokens)
            overflows.append(item[3])
            if serial:
                _write(serial_file, *fetch_vol(item))
            else:
                if pending is not None:
                    fetch_and_enqueue(pending)
                pending = item
                if staged is None:
                    break
        if not serial:
            if pending is not None:
                fetch_and_enqueue(pending)
            with span("ver_writer#drain", device=False):
                write_q.put(None)
                wt.join()
            if werr:
                raise RuntimeError("HDF5 writer failed") from werr[0]
    finally:
        if serial_file is not None:
            serial_file.close()
        if transfer is not None:
            transfer.shutdown(wait=True)
        # an exception above skips the success path's sentinel: without
        # one the writer would block forever holding the file open
        if wt is not None and wt.is_alive():
            try:
                write_q.put(None, timeout=30)
            except queue_mod.Full:
                pass
            wt.join(timeout=30)
    dt = time.perf_counter() - t0
    overflow = max((int(o) for o in overflows), default=0)
    if mesh is not None and mesh.distributed:
        from .parallel.multihost import allreduce_max
        overflow = allreduce_max(overflow, group=mesh.world_group)
    return dict(written=written, seconds=dt,
                volumes_per_sec=written / max(dt, 1e-9),
                sca_overflow=overflow)
