"""Pipeline parallelism: a GPipe schedule over a stack of uniform layers
(PyTorch port of ``vln_ver_tpu/parallel/pipeline.py``).

JAX runs the schedule inside one ``shard_map``: a ``lax.scan`` over ``M +
S - 1`` ticks advances every stage in lockstep, ``ppermute`` hops the
activations to the next stage and a masked ``psum`` replicates the last
stage's outputs; autodiff transposes all of it.  Here each stage is a
process of a ``(stage, data)`` grid (:func:`make_pp_mesh`) and the same
schedule is written out:

* stage ``s`` owns the contiguous block of ``L / S`` layers
  (:func:`stage_layers`);
* the batch splits into ``M`` microbatches; stage ``s`` runs microbatch
  ``t - s`` at tick ``t``: stage 0 takes it from ``x``, a later stage
  receives it from stage ``s - 1``, and every stage but the last sends its
  output on to ``s + 1`` (point-to-point over the stage's data column; a
  stage skips its bubble ticks, so no layer runs on padding);
* the last stage's outputs are broadcast to every stage;
* under a ``(stage, data)`` grid each data rank takes its ``mb / D`` rows of
  every microbatch.

The gradients run through the sends, receives and the broadcast
(``torch.autograd.Function``\\s): a send's backward receives the gradient of
what it sent, a receive's backward sends the gradient of what it received,
and the broadcast's backward gives the last stage its own cotangent (not
the sum of the ``S`` identical ones, which would be ``S`` times the
sequential stack's gradient).  The sends and receives of each rank form a
chain from stage 0 to the last and back, so no two neighbours wait on each
other; messages carry the microbatch as their tag.

Layers must be batch-elementwise (true for the encoder's layers:
attention, FFN and LayerNorm mix nothing across rows).  Each stage's layer
gradients are ``sequential_apply``'s for those layers; the gradients of
``x`` and of the batch args, summed over the stage group, are the
sequential stack's.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, grid_mesh


def make_pp_mesh(stage: int, data: int = 1) -> Mesh:
    """The ``(stage, data)`` grid over the whole world, rank ``r = s * D +
    d``: each stage row holds ``data`` ranks that split the microbatch
    rows.  ``stage x data`` must equal the world size."""
    return grid_mesh(("stage", "data"), (stage, data))


def stage_layers(mesh: Mesh, layers: Sequence) -> List:
    """This stage's contiguous block of ``len(layers) / S`` layers (the
    counterpart of ``stack_layer_params``' leading axis sharded over
    ``stage``)."""
    n_stages, n = mesh.size("stage"), len(layers)
    if n % n_stages:
        raise ValueError(f"{n} layers over {n_stages} stages")
    per = n // n_stages
    s = mesh.index("stage")
    return list(layers)[s * per:(s + 1) * per]


def sequential_apply(layer_fn: Callable, layers: Sequence, x: torch.Tensor,
                     *batch_args, shared=()) -> torch.Tensor:
    """Reference semantics: ``layer_fn(layer, h, *batch_args, *shared)``
    layer after layer."""
    h = x
    for layer in layers:
        h = layer_fn(layer, h, *batch_args, *shared)
    return h


class _Send(torch.autograd.Function):
    """Send ``h`` to ``peer``; returns a scalar token whose backward
    receives ``h``'s gradient from ``peer``."""

    @staticmethod
    def forward(ctx, h, peer, tag):
        ctx.peer, ctx.tag = peer, tag
        ctx.like = (h.shape, h.dtype, h.device)
        dist.send(h.contiguous(), peer, tag=tag)
        return h.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, ctx.peer, tag=ctx.tag)
        return grad, None, None


class _Recv(torch.autograd.Function):
    """Receive a tensor like ``like`` from ``peer``; its backward sends the
    gradient back.  ``anchor`` (a scalar that requires grad under grad
    mode) makes the output part of the graph."""

    @staticmethod
    def forward(ctx, anchor, like, peer, tag):
        ctx.peer, ctx.tag = peer, tag
        h = torch.empty_like(like)
        dist.recv(h, peer, tag=tag)
        return h

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.peer, tag=ctx.tag)
        return None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's ``outs`` to every stage of ``group``.  The
    backward passes the last stage its own cotangent and the other
    stages' send tokens a zero, which starts their sends' backward."""

    @staticmethod
    def forward(ctx, outs, src, group, *tokens):
        ctx.n_tokens = len(tokens)
        out = outs.clone()
        if group is not None:
            dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad, None, None) + tuple(
            grad.new_zeros(()) for _ in range(ctx.n_tokens))


def pipeline_apply(mesh: Mesh, layer_fn: Callable, layers: Sequence,
                   x: torch.Tensor, *batch_args, shared=(),
                   microbatches: int = 2) -> torch.Tensor:
    """Run ``x`` through the ``L`` layers of ``layers`` pipelined over the
    mesh's ``stage`` axis (``L % S == 0``); every rank calls this with the
    same arguments.

    ``layer_fn(layer, h, *batch_args_mb, *shared) -> h`` is one layer, its
    output of ``h``'s shape.  Batch dim 0 of ``x`` and of every
    ``batch_args`` tensor (the SCA's value, reference points and masks are
    per sample) splits into ``microbatches`` equal microbatches; ``shared``
    goes to every layer whole.

    Returns this data rank's rows of the output, on every stage: of each
    microbatch of ``mb = B / M`` rows the block ``[d * mb / D, (d + 1) * mb
    / D)``, microbatch after microbatch (all of ``B`` rows at ``D = 1``)."""
    n_stages = mesh.size("stage")
    n_data = mesh.size("data")
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers over {n_stages} stages")
    m = int(microbatches)
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} into {m} microbatches")
    mb = b // m
    if mb % n_data:
        raise ValueError(
            f"microbatch rows {mb} (batch {b} / {m} microbatches) must be "
            f"divisible by the mesh data axis size {n_data}")
    rows = mb // n_data
    lo = mesh.index("data") * rows

    def split(a):       # (B, ...) -> (M, rows, ...): this rank's rows
        return a.reshape(m, mb, *a.shape[1:])[:, lo:lo + rows]

    x_mb = split(x)
    bargs_mb = [split(a) for a in batch_args]
    s = mesh.index("stage")
    last = s == n_stages - 1
    mine = stage_layers(mesh, layers)
    anchor = torch.zeros((), device=x.device,
                         requires_grad=torch.is_grad_enabled())
    outs, tokens = [], []
    # stage s reaches microbatch k at tick s + k; the receive waits for
    # stage s - 1's tick s - 1 + k
    for k in range(m):
        if s == 0:
            h = x_mb[k]
        else:
            h = _Recv.apply(anchor, x_mb[k].detach(),
                             mesh.rank_of(stage=s - 1), k)
        h = sequential_apply(layer_fn, mine, h,
                             *(a[k] for a in bargs_mb), shared=shared)
        if last:
            outs.append(h)
        else:
            tokens.append(_Send.apply(h, mesh.rank_of(stage=s + 1), k))
    stacked = torch.stack(outs) if last else torch.zeros_like(x_mb)
    group = mesh.groups.get("stage")
    y = _Broadcast.apply(stacked, mesh.rank_of(stage=n_stages - 1), group,
                         *tokens)
    return y.reshape(m * rows, *x.shape[1:])
