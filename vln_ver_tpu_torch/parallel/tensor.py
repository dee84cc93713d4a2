"""Tensor parallelism: large parameters held in shards over a ``model``
axis (PyTorch port of ``vln_ver_tpu/parallel/tensor.py``).

JAX places every parameter matrix above a size threshold, and its AdamW
moments, on the mesh with its largest model-divisible axis sharded over
``model`` (:func:`param_pspec`), and lets GSPMD insert the gathers and
reductions.  The port keeps the same rule and the same memory at rest,
with the collectives written out (:class:`TensorParallel`):

* at rest, a rank holds only its slice of every sharded parameter and of
  its AdamW ``exp_avg`` / ``exp_avg_sq``; scalars and small or indivisible
  parameters replicate;
* a step all-gathers the full parameters over the model group into the
  module, runs the forward and backward as the replicated step does,
  averages the gradients over the grid (model and view ranks hold the
  same rows), clips them by the global norm of the full gradients, then
  cuts each sharded parameter and its gradient back to this rank's slice
  and takes AdamW on the slices.  AdamW is elementwise, so the update
  equals the replicated one; the full parameters are freed with the cut.

The state in its replicated layout, for a checkpoint or an eval, is
:func:`gathered`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, grid_mesh

MIN_SIZE = 1 << 15


def make_tp_mesh(data: int, model: int, view: int = 1) -> Mesh:
    """The (data, view, model) grid over the whole world, rank ``r = (d *
    V + v) * M + m`` (JAX's ``reshape(data, view, model)`` of the device
    list): the batch over ``data``, the cameras over ``view``, the
    parameter shards over ``model``, with a group for each."""
    return grid_mesh(("data", "view", "model"), (data, view, model))


def param_pspec(shape: Sequence[int], model_size: int,
                min_size: int = MIN_SIZE) -> Optional[int]:
    """The axis of a parameter of ``shape`` that is sharded over ``model``,
    or None to replicate it, by JAX's rule: the LARGEST axis divisible by
    ``model_size``, ties to the LAST such axis; replicated below
    ``min_size`` elements or under 2 dims.

    Applied to the torch shape.  A torch weight has the flax kernel's
    dimensions permuted (``nn.Linear``'s ``(out, in)`` for flax's ``(in,
    out)``), so the set of sharded parameters, and :func:`tp_fraction`, are
    JAX's; but a square weight's tie-break lands on the input axis here,
    where flax's lands on the output axis."""
    shape = tuple(int(n) for n in getattr(shape, "shape", shape))
    if len(shape) < 2 or int(np.prod(shape)) < min_size:
        return None
    best_ax, best = None, -1
    for ax, n in enumerate(shape):
        if n % model_size == 0 and n >= model_size and n >= best:
            best, best_ax = n, ax
    return best_ax


class TensorParallel:
    """The shards of a module's parameters over ``mesh``'s model group.

    The module's sharded :class:`~torch.nn.Parameter` objects stay the
    optimizer's: between steps their ``.data`` is this rank's slice (and so
    are the moments AdamW creates for them); :meth:`gather` puts the full
    tensors in their place, :meth:`shard` cuts them, and their gradients
    when present, back to the slice."""

    def __init__(self, mesh: Mesh, module: torch.nn.Module,
                 min_size: int = MIN_SIZE):
        self.mesh = mesh
        self.size = mesh.size("model")
        self.index = mesh.index("model")
        self.group = mesh.groups.get("model")
        if self.group is None and self.size > 1:
            raise ValueError(f"a model axis of {self.size} needs a process "
                             "group")
        self.axes: Dict[torch.nn.Parameter, int] = {}
        self.shapes: Dict[torch.nn.Parameter, torch.Size] = {}
        for p in module.parameters():
            ax = param_pspec(p.shape, self.size, min_size)
            if ax is not None:
                self.axes[p] = ax
                self.shapes[p] = p.shape
        self.params_full = self.moments_full = True

    def _cut(self, t: torch.Tensor, ax: int) -> torch.Tensor:
        n = t.shape[ax] // self.size
        return t.narrow(ax, self.index * n, n).clone()

    def _join(self, t: torch.Tensor, ax: int) -> torch.Tensor:
        """The model group's slices of ``t`` joined along ``ax`` (a copy
        of ``t`` without a process group, where the axis is 1)."""
        if self.group is None:
            return t.clone()
        src = t.movedim(ax, 0).contiguous()
        out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.movedim(0, ax).contiguous()

    def _moments(self, optimizer):
        """(parameter, state key, axis) of every moment of a sharded
        parameter: the optimizer's tensors of the parameter's shape in the
        moments' current layout."""
        for p, ax in self.axes.items():
            shape = list(self.shapes[p])
            if not self.moments_full:
                shape[ax] //= self.size
            for k, t in optimizer.state.get(p, {}).items():
                if torch.is_tensor(t) and list(t.shape) == shape:
                    yield p, k, ax

    @torch.no_grad()
    def gather(self) -> None:
        """The full parameters into the module (a collective); the slices'
        gradients are dropped."""
        if not self.params_full:
            for p, ax in self.axes.items():
                p.grad = None
                p.data = self._join(p.data, ax)
            self.params_full = True

    @torch.no_grad()
    def shard(self) -> None:
        """Each sharded parameter, and its gradient where it has one, cut
        to this rank's slice; the full tensors are freed."""
        if self.params_full:
            for p, ax in self.axes.items():
                grad = None if p.grad is None else self._cut(p.grad, ax)
                p.grad = None
                p.data = self._cut(p.data, ax)
                p.grad = grad
            self.params_full = False

    @torch.no_grad()
    def gather_moments(self, optimizer) -> None:
        """The full AdamW moments into the optimizer (a collective)."""
        if not self.moments_full:
            for p, k, ax in list(self._moments(optimizer)):
                optimizer.state[p][k] = self._join(optimizer.state[p][k], ax)
            self.moments_full = True

    @torch.no_grad()
    def shard_moments(self, optimizer) -> None:
        """The AdamW moments of the sharded parameters cut to this rank's
        slice."""
        if self.moments_full:
            for p, k, ax in list(self._moments(optimizer)):
                optimizer.state[p][k] = self._cut(optimizer.state[p][k], ax)
            self.moments_full = False


def shard_params(mesh: Mesh, module: torch.nn.Module,
                 min_size: int = MIN_SIZE) -> TensorParallel:
    """Shard ``module``'s parameters by :func:`param_pspec` over ``mesh``'s
    model axis, in place (every rank must hold the same parameters, as
    ``parallel.mesh.replicate`` leaves them); returns the layout."""
    tp = TensorParallel(mesh, module, min_size)
    tp.shard()
    return tp


def shard_state(mesh: Mesh, state, min_size: int = MIN_SIZE):
    """Shard a :class:`~vln_ver_tpu_torch.train.TrainState`, in place: the
    parameters by the rule and the matching AdamW moments; the step and
    every small parameter replicate.  Returns ``state``, whose ``tp`` the
    train step then gathers and cuts."""
    state.tp = shard_params(mesh, state.model, min_size)
    state.tp.shard_moments(state.optimizer)
    return state


@contextlib.contextmanager
def gathered(state, moments: bool = True):
    """Within the block ``state`` is in its replicated layout: the full
    parameters in the module and, with ``moments``, the full AdamW
    moments in the optimizer (collectives: every rank enters).  What the
    block loads into them is sharded on the way out.  A replicated state
    is left as it is."""
    tp = getattr(state, "tp", None)
    if tp is None:
        yield state
        return
    tp.gather()
    if moments:
        tp.gather_moments(state.optimizer)
    try:
        yield state
    finally:
        tp.shard()
        tp.shard_moments(state.optimizer)


def _full_shapes(state_or_module):
    module = getattr(state_or_module, "model", state_or_module)
    tp = getattr(state_or_module, "tp", None)
    return [tp.shapes.get(p, p.shape) if tp is not None else p.shape
            for p in module.parameters()]


def tp_fraction(state_or_module, mesh: Mesh,
                min_size: int = MIN_SIZE) -> float:
    """The fraction of parameter elements :func:`param_pspec` shards at
    ``mesh``'s model size (diagnostics)."""
    m = mesh.size("model")
    tot = shd = 0
    for shape in _full_shapes(state_or_module):
        n = int(np.prod(shape))
        tot += n
        if param_pspec(shape, m, min_size) is not None:
            shd += n
    return shd / max(tot, 1)


def rule_bytes(state_or_module, model_size: int,
               min_size: int = MIN_SIZE) -> int:
    """The bytes a rank holds at rest under the rule at ``model_size``:
    three tensors of each parameter's size and dtype (the parameter and
    AdamW's two moments), a sharded one's divided by ``model_size``."""
    module = getattr(state_or_module, "model", state_or_module)
    total = 0
    for shape, p in zip(_full_shapes(state_or_module), module.parameters()):
        n = int(np.prod(shape))
        if param_pspec(shape, model_size, min_size) is not None:
            n //= model_size
        total += 3 * n * p.element_size()
    return total


def resident_bytes(state) -> int:
    """The bytes of ``state``'s parameters and AdamW moments this rank
    holds now (the moments of the parameter's shape; the step counters
    are not counted)."""
    total = 0
    for p in state.model.parameters():
        total += p.numel() * p.element_size()
        for t in state.optimizer.state.get(p, {}).values():
            if torch.is_tensor(t) and t.shape == p.shape:
                total += t.numel() * t.element_size()
    return total
