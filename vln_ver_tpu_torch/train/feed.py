"""Host-to-device staging for the train loop (PyTorch port of
``vln_ver_tpu/train/feed.py``): a one-ahead transfer thread, so that batch
k+1's copy to the card runs while batch k's step runs."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def staged_batches(batches: Iterable, place: Callable,
                   name: str = "train_transfer") -> Iterator:
    """Yield ``place(batch)`` for each host batch, computing the NEXT
    placement on a transfer thread while the caller consumes the current
    one.  Exceptions from ``place`` (or the iterator) re-raise in the
    consumer at the matching ``next()``."""
    it = iter(batches)
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=name)
    try:
        first = next(it, _SENTINEL)
        if first is _SENTINEL:
            return
        fut = pool.submit(place, first)
        for nxt in it:
            cur = fut.result()
            fut = pool.submit(place, nxt)
            yield cur
        yield fut.result()
    finally:
        pool.shutdown(wait=False)


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The numeric arrays of a collated host batch as tensors on
    ``device`` (the token list is dropped).  For a card: pinned host
    memory and non-blocking copies on the current stream, so the copy
    queues behind the work already there and the caller does not wait."""
    out = {}
    for k, v in batch.items():
        if k == "token":
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
