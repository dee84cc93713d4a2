"""The process grid (PyTorch port of ``vln_ver_tpu/parallel/mesh.py``).

JAX expresses the parallelism as shardings over a device mesh and lets
GSPMD insert the collectives.  Here a process is one card, and a
:class:`Mesh` is the grid of the whole world, the product of its axes
equal to ``WORLD_SIZE``, its ranks in row-major order of the axes:

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
* ``slice`` (:func:`make_multislice_mesh`, ``(slice, data, view)``) is a
  node: the batch splits over ``(slice, data)`` jointly, the view group
  stays inside a node, and the gradients are averaged within each node
  before one all-reduce over the slice group crosses the nodes.
* ``model`` (``parallel.tensor.make_tp_mesh``, ``(data, view, model)``)
  holds the tensor-parallel shards of the parameters; its ranks hold the
  same rows.
* ``stage`` (``parallel.pipeline.make_pp_mesh``, ``(stage, data)``) holds
  the pipeline's stages.

The batch-carrying index and size, ``data_index`` and :attr:`Mesh.data_size`,
are the joint ``s * D + d`` and ``S * D`` of the ``slice`` and ``data`` axes.

:func:`data_parallel` marks a block in which the batch's rows are this
rank's share of a global batch: dropout masks and the agent's MLM masks are
drawn for the global batch and cut to the rank's rows (:func:`draw_rows`),
and :func:`global_count` sums over the data group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import multihost

# batch entries with a camera axis (axis 1), split over ``view``; "images"
# is the fused image path's raw uint8 views (vln_ver_tpu/parallel/mesh.py:83)
VIEW_KEYS = ("features", "world2pixel", "images")
# the axes that split the batch, jointly in this order
BATCH_AXES = ("slice", "data")


@dataclasses.dataclass(frozen=True)
class ViewShard:
    """What the lift needs of the view axis: the group to all-reduce over,
    this rank's place in it and its size."""
    group: object
    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and its process groups.  ``shape``
    holds the sizes of ``axis_names`` and ``coords`` this rank's index on
    each (default: ``(data_index, view_index)`` of a (data, view) grid);
    ``groups`` the group along each other axis (``slice``, ``model``,
    ``stage``) and ``local``, the ranks of this rank's slice."""
    shape: Tuple[int, ...]
    data_index: int                 # the batch shard, s * D + d
    view_index: int
    data_group: object = None       # the batch axes' ranks (size S x D)
    view_group: object = None       # the view axis' ranks (size V)
    world_group: object = None
    axis_names: Tuple[str, ...] = ("data", "view")
    coords: Tuple[int, ...] = ()
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.coords:
            object.__setattr__(self, "coords",
                               (self.data_index, self.view_index))

    def size(self, axis: str) -> int:
        """The size of ``axis`` (1 for an axis the grid lacks)."""
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 for an axis the grid lacks)."""
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)

    def rank_of(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords``
        replaced."""
        at = [coords.get(n, c) for n, c in zip(self.axis_names, self.coords)]
        return int(np.ravel_multi_index(at, self.shape))

    @property
    def data_size(self) -> int:
        """The number of batch shards, ``S x D``."""
        return int(np.prod([self.size(a) for a in BATCH_AXES]))

    @property
    def view_size(self) -> int:
        return self.size("view")

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
        """Whether this rank writes its data group's outputs (view and
        model rank 0: those ranks hold the same rows)."""
        return self.view_index == 0 and self.index("model") == 0


def grid_mesh(axis_names: Sequence[str], shape: Sequence[int]) -> Mesh:
    """The grid of ``axis_names`` with sizes ``shape`` over the whole world,
    rank ``r`` at ``np.unravel_index(r, shape)``.  The product of ``shape``
    must equal the world size.  Every rank calls this with the same
    arguments: it creates the process groups, a collective call, every
    group in the same order."""
    names, shape = tuple(axis_names), tuple(int(s) for s in shape)
    world = multihost.process_count()
    if len(names) != len(shape) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} for axes {names}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs "
                         f"{int(np.prod(shape))} processes, the world has "
                         f"{world}")
    rank = multihost.process_index()
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    at = dict(zip(names, coords))
    sizes = dict(zip(names, shape))
    data_index = at.get("slice", 0) * sizes.get("data", 1) + at.get("data", 0)
    kw = dict(axis_names=names, coords=coords)
    if not multihost.is_distributed():
        return Mesh(shape, data_index, at.get("view", 0), **kw)
    grid = np.arange(world).reshape(shape)

    def group(varying):
        """The group over the ``varying`` axes through this rank: one
        group for every point of the other axes, all of them created."""
        axes = [names.index(a) for a in varying if a in names]
        if not axes:
            return None
        rows = np.moveaxis(grid, axes, range(-len(axes), 0)).reshape(
            -1, int(np.prod([shape[a] for a in axes])))
        mine = None
        for ranks in rows:
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                mine = g
        return mine

    data_group = group(BATCH_AXES)
    view_group = group(("view",))
    groups = {a: group((a,)) for a in ("slice", "model", "stage")
              if a in names}
    if "slice" in names:
        groups["local"] = group(tuple(a for a in names if a != "slice"))
    return Mesh(shape, data_index, at.get("view", 0), data_group, view_group,
                dist.group.WORLD, groups=groups, **kw)


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The (data, view) grid over the whole world; default ``(world, 1)``.
    ``D x V`` must equal the world size.  Every rank calls this with the
    same shape (it creates the process groups, a collective call)."""
    world = multihost.process_count()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"mesh shape must be (data, view), got {shape}")
    return grid_mesh(("data", "view"), shape)


def node_count() -> int:
    """The nodes of a torchrun launch, ``WORLD_SIZE // LOCAL_WORLD_SIZE``
    (1 without them)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)


def make_multislice_mesh(num_slices: int, data: int, view: int = 1) -> Mesh:
    """The (slice, data, view) grid, slice-major: rank ``r = (s * D + d) *
    V + v``.  A slice is a node of the launch (torchrun numbers ranks node
    by node), so the view all-reduces stay inside a node and the only
    collective across nodes is the gradient all-reduce over the slice
    group (:func:`allreduce_grads`).  On more than one node the node
    count must be ``num_slices``: any other split would put nodes inside
    the data and view groups (vln_ver_tpu/parallel/mesh.py:61-69).  On one
    node (the CPU tests, one card) the same order is a plain reshape."""
    nodes = node_count()
    if nodes > 1 and nodes != num_slices:
        raise ValueError(
            f"num_slices={num_slices} but the launch spans {nodes} nodes "
            f"(WORLD_SIZE // LOCAL_WORLD_SIZE); pass num_slices={nodes} so "
            "the 'slice' axis is the axis across nodes")
    return grid_mesh(("slice", "data", "view"), (num_slices, data, view))


def data_axis_size(mesh: Mesh) -> int:
    """The product of the batch-carrying axes (``slice``, ``data``): the
    granularity batch dims must divide for :func:`shard_batch`."""
    return mesh.data_size


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
    """This rank's rows (the batch split ``S x D`` ways over the batch
    axes, in order of the joint index) and, for the
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
    """The number of batch shards (``S x D``) sharing the global batch (1
    outside :func:`data_parallel`)."""
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
    parameter); call after the backward and before the clip.  On a
    multi-slice grid the average is taken in two levels, over the ranks
    of each slice and then over the slice group, so that one all-reduce
    crosses the nodes."""
    if not mesh.distributed:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    levels = ((mesh.groups["local"], mesh.groups["slice"])
              if "slice" in mesh.groups else (mesh.world_group,))
    for group in levels:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= dist.get_world_size(group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
