"""The (data, view) process grid (PyTorch port of
``vln_ver_tpu/parallel/mesh.py``).

JAX expresses the parallelism as shardings over a device mesh and lets
GSPMD insert the collectives.  Here a process is one card, and a
:class:`Mesh` is the grid of the whole world, ``D x V = WORLD_SIZE``,
rank ``r`` at ``(data, view) = divmod(r, V)``:

* ``data`` splits the batch (viewpoints): the DP axis.  The gradients are
  all-reduced over the world (:func:`allreduce_grads`), and the losses
  divide by avg factors summed over the data group (:func:`global_count`),
  as the reference's ``reduce_mean`` does, so a step equals the
  one-process step on the global batch.
* ``view`` splits the camera axis.  The lift is a sum over cameras then a
  divide by the per-query hit count (spatial_cross_attention.py:137-173);
  each view rank attends over its own cameras and the fp32 slot sum and
  hit count are all-reduced over the view group
  (``models/attention.SpatialCrossAttention``).  Every view rank then holds
  the same rows and computes the same post-lift network.

:func:`data_parallel` marks a block in which the batch's rows are this
rank's share of a global batch: dropout masks and the agent's MLM masks are
drawn for the global batch and cut to the rank's rows (:func:`draw_rows`),
and :func:`global_count` sums over the data group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import multihost

# batch entries with a camera axis (axis 1), split over ``view``; "images"
# is the fused image path's raw uint8 views (vln_ver_tpu/parallel/mesh.py:83)
VIEW_KEYS = ("features", "world2pixel", "images")


@dataclasses.dataclass(frozen=True)
class ViewShard:
    """What the lift needs of the view axis: the group to all-reduce over,
    this rank's place in it and its size."""
    group: object
    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, int]          # (D, V)
    data_index: int
    view_index: int
    data_group: object = None       # ranks of this view index (size D)
    view_group: object = None       # ranks of this data index (size V)
    world_group: object = None

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def view_size(self) -> int:
        return self.shape[1]

    @property
    def distributed(self) -> bool:
        return self.world_group is not None

    @property
    def views(self) -> Optional[ViewShard]:
        """The lift's view shard; None when the cameras are not split."""
        if self.view_size == 1:
            return None
        return ViewShard(self.view_group, self.view_index, self.view_size)

    @property
    def writer(self) -> bool:
        """Whether this rank writes its data group's outputs (view rank 0:
        every view rank holds the same rows)."""
        return self.view_index == 0


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The (data, view) grid over the whole world; default ``(world, 1)``.
    ``D x V`` must equal the world size.  Every rank calls this with the
    same shape (it creates the process groups, a collective call)."""
    world = multihost.process_count()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"mesh shape must be (data, view), got {shape}")
    d, v = shape
    if d * v != world:
        raise ValueError(f"mesh {d}x{v} needs {d * v} processes, the world "
                         f"has {world}")
    rank = multihost.process_index()
    di, vi = divmod(rank, v)
    if not multihost.is_distributed():
        return Mesh(shape, di, vi)
    data_group = view_group = None
    # every rank creates every group, in the same order
    for j in range(v):
        g = dist.new_group([i * v + j for i in range(d)])
        if j == vi:
            data_group = g
    for i in range(d):
        g = dist.new_group([i * v + j for j in range(v)])
        if i == di:
            view_group = g
    return Mesh(shape, di, vi, data_group, view_group, dist.group.WORLD)


def parse_eval_mesh(arg: Optional[str]) -> Optional[Mesh]:
    """CLI ``--mesh data[,view]`` -> :func:`make_mesh`.  Without the flag
    (None): the world's ``(world, 1)`` grid under a process group of more
    than one process, else None (one process, no mesh)."""
    if arg is None:
        return make_mesh() if multihost.process_count() > 1 else None
    shape = tuple(int(x) for x in str(arg).split(","))
    if len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) != 2:
        raise ValueError(f"--mesh wants 'data' or 'data,view', got {arg!r}")
    return make_mesh(shape)


def _rows(v) -> Optional[int]:
    if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0:
        return int(v.shape[0])
    if isinstance(v, (list, tuple)):
        return len(v)
    return None


def shard_views(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's camera block of the :data:`VIEW_KEYS` entries (axis 1);
    the rest as it is.  The camera count must divide by V."""
    v, vi = mesh.view_size, mesh.view_index
    if v == 1:
        return dict(batch)
    out = {}
    for k, x in batch.items():
        if k in VIEW_KEYS:
            cams = x.shape[1]
            if cams % v:
                raise ValueError(f"{k}: {cams} cameras do not divide over "
                                 f"{v} view ranks")
            c = cams // v
            x = x[:, vi * c:(vi + 1) * c]
        out[k] = x
    return out


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's rows (the batch split D ways, in order) and, for the
    :data:`VIEW_KEYS`, its camera block.  Arrays, tensors and per-row lists
    (tokens) are split; other entries stay whole."""
    d, di = mesh.data_size, mesh.data_index
    out = {}
    for k, x in batch.items():
        n = _rows(x)
        if n is not None and d > 1:
            if n % d:
                raise ValueError(f"{k}: batch dim {n} not divisible by the "
                                 f"mesh's data size {d}")
            b = n // d
            x = x[di * b:(di + 1) * b]
        out[k] = x
    return shard_views(mesh, out)


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place;
    returns ``module``."""
    if not mesh.distributed:
        return module
    dev = multihost.collective_device()
    for t in list(module.parameters()) + list(module.buffers()):
        buf = t.detach().to(dev)
        dist.broadcast(buf, src=0)
        t.copy_(buf)
    return module


# ---- data-parallel blocks ---------------------------------------------------

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Within the block the batch's rows are this rank's equal share of a
    global batch split over ``mesh``'s data axis (None: no mesh)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = saved


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE


def data_size() -> int:
    """The number of data ranks sharing the global batch (1 outside
    :func:`data_parallel`)."""
    return 1 if _ACTIVE is None else _ACTIVE.data_size


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for a local ``shape`` whose leading dim is the rows:
    inside :func:`data_parallel`, ``draw`` runs on the global batch's shape
    and this rank's rows of it come back, so every rank takes the rows of
    the draw the one-process run makes (and the generators stay in
    step)."""
    if _ACTIVE is None or _ACTIVE.data_size == 1:
        return draw(tuple(shape))
    b = int(shape[0])
    full = draw((b * _ACTIVE.data_size,) + tuple(shape[1:]))
    lo = _ACTIVE.data_index * b
    return full[lo:lo + b]


def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a count or sum, no gradient) summed over the data group
    inside :func:`data_parallel`; ``x`` itself outside it."""
    if _ACTIVE is None or not _ACTIVE.distributed:
        return x
    t = x.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_ACTIVE.data_group)
    return t


def global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """A mean over the global batch from this rank's ``total`` (with
    gradient) and ``count`` of items: ``total / global count``, times the
    number of data ranks, so that the mean over ranks of the result (what
    :func:`allreduce_grads` averages) is the global mean.  Outside
    :func:`data_parallel`, ``total / max(count, 1)``."""
    count = torch.as_tensor(count, dtype=total.dtype, device=total.device)
    return total * data_size() / global_count(count).clamp(min=1)


def mean_over_data(mesh: Optional[Mesh],
                   values: torch.Tensor) -> torch.Tensor:
    """The mean over ``mesh``'s data group of per-rank ``values`` (the
    logged losses of :func:`global_mean`: the global batch's)."""
    if mesh is None or not mesh.distributed:
        return values
    t = values.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return t / mesh.data_size


def allreduce_grads(mesh: Mesh, params: Sequence[torch.nn.Parameter]
                    ) -> None:
    """Average the parameters' gradients over the world, in one flat
    all-reduce in a fixed order (a parameter autograd left without one
    takes a zero gradient, so no rank waits on another's unused
    parameter); call after the backward and before the clip."""
    if not mesh.distributed:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.world_group)
    flat /= dist.get_world_size(mesh.world_group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
