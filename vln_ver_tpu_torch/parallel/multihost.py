"""Multi-process utilities (PyTorch port of
``vln_ver_tpu/parallel/multihost.py``).

``torch.distributed`` takes the place of ``jax.distributed``: a process is
one card (or, for the CPU tests, one gloo rank), brought up from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``).  Eval splits are sharded in contiguous
blocks (the reference's deterministic eval sampler,
samplers/distributed_sampler.py:36-39) and per-sample results are gathered
back in (process, index) order.

Under NCCL every tensor a collective touches lives on the rank's card;
the helpers here move host arrays there and back (:func:`collective_device`).
Without a process group every helper is the single-process identity.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

# numpy dtypes that cross a collective, by a code every rank agrees on
_DTYPES = ("float32", "float64", "int32", "int64", "bool", "uint8",
           "float16", "int8")


def initialize_if_needed(device="cuda") -> torch.device:
    """Bring up ``torch.distributed`` when torchrun's environment is set
    (``WORLD_SIZE``); returns the device this rank runs on.

    NCCL on ``cuda:LOCAL_RANK`` for a CUDA ``device``, gloo only for the
    CPU.  Without the environment, or when a group is already up, nothing
    is initialised and ``device`` comes back (on CUDA, the rank's card when
    a group is up)."""
    device = torch.device(device)
    if dist.is_initialized():
        return _rank_device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=_rank_device(device))
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return _rank_device(device)


def _rank_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else torch.cuda.current_device())


def shutdown() -> None:
    """Destroy the default process group, where one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index(group=None) -> int:
    return dist.get_rank(group) if is_distributed() else 0


def process_count(group=None) -> int:
    return dist.get_world_size(group) if is_distributed() else 1


def collective_device() -> torch.device:
    """Where a collective's tensors must live: the current card under
    NCCL, the CPU under gloo (or with no group)."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_indices(n: int, index: Optional[int] = None,
                  count: Optional[int] = None) -> range:
    """Contiguous block ``index`` of ``count`` (default: this process of
    the world) over ``range(n)``: blocks of ``ceil(n / count)``, the last
    one short or empty."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    per = -(-n // count)
    lo = min(index * per, n)
    return range(lo, min(lo + per, n))


def shard_size(n: int, count: Optional[int] = None) -> int:
    """The largest block of :func:`shard_indices` (the padding target of
    :func:`allgather_results`)."""
    count = process_count() if count is None else count
    return -(-n // count)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a.view(np.uint8) if a.dtype == bool else a)
    return t.to(collective_device())


def _from_tensor(t: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    a = t.cpu().numpy()
    return a.view(bool) if dtype == bool else a


def _all_gather(t: torch.Tensor, world: int, group) -> torch.Tensor:
    """(world, *t.shape): every process's ``t``, stacked in process
    order."""
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def allgather_results(local, per: int, group=None) -> List[np.ndarray]:
    """Gather every process's result rows to every process.

    ``local`` is this process's ``(k, ...)`` rows, ``k <= per`` and possibly
    0; the trailing shape and dtype agree across processes that have rows.
    Returns the rows of every process in (process, index) order, padding
    removed: aligned with the unsharded split when the shards came from
    :func:`shard_indices`.  Every process enters the same collectives
    whether or not it has rows (a trailing empty shard takes its shape
    from the first process that has rows), so none is left waiting."""
    local = np.asarray(local)
    if not is_distributed():
        return [local[i] for i in range(len(local))]
    if len(local) > per:
        raise ValueError(f"local count {len(local)} exceeds pad target "
                         f"{per}")
    world = process_count(group)
    # (count, dtype code, ndim, trailing dims...) of every process
    meta = np.full(10, -1, np.int64)
    meta[0] = len(local)
    if len(local):
        if local.ndim - 1 > 7:
            raise ValueError(f"rows of {local.ndim - 1} dims: at most 7")
        meta[1] = _DTYPES.index(local.dtype.name)
        meta[2] = local.ndim - 1
        meta[3:3 + local.ndim - 1] = local.shape[1:]
    metas = _all_gather(_to_tensor(meta), world, group).cpu().numpy()
    have = [m for m in metas if m[0] > 0]
    if not have:
        return []
    dtype = np.dtype(_DTYPES[int(have[0][1])])
    trail = tuple(int(x) for x in have[0][3:3 + int(have[0][2])])
    padded = np.zeros((per,) + trail, dtype)
    padded[:len(local)] = local
    gathered = _from_tensor(_all_gather(_to_tensor(padded), world, group),
                            dtype)
    return [gathered[p, i] for p in range(world)
            for i in range(int(metas[p][0]))]


def allreduce_sum(array, group=None) -> np.ndarray:
    """Sum a fixed-shape host array over processes (the metric
    histograms)."""
    array = np.asarray(array)
    if not is_distributed():
        return array
    t = _to_tensor(array)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return _from_tensor(t, array.dtype)


def allreduce_max(value: int, group=None) -> int:
    """The largest of one integer over processes (``sca_overflow``)."""
    if not is_distributed():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def allgather_objects(obj, group=None) -> list:
    """Every process's picklable ``obj``, in process order."""
    if not is_distributed():
        return [obj]
    out = [None] * process_count(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def run_once(fn):
    """``fn()`` on process 0 only (it writes files every process then
    reads: a synthetic split, a checkpoint); every process gets its return
    value once it is done."""
    if not is_distributed():
        return fn()
    return allgather_objects(fn() if process_index() == 0 else None)[0]

