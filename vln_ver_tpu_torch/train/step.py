"""The train step (PyTorch port of ``vln_ver_tpu/train/step.py``):
forward in ``train()`` mode, losses and matching, backward, gradient clip
and AdamW, run eagerly on the model's device."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import VERConfig
from ..parallel.mesh import allreduce_grads, data_parallel, mean_over_data
from ..runtime import fp32_precision
from ..utils.profiling import span
from .objective import compute_losses
from .state import TrainConfig, TrainState


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step: a fixed function of (seed, step), the
    role of ``jax.random.fold_in(rng, step)``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def make_train_step(cfg: VERConfig, tc: TrainConfig,
                    mesh=None) -> Callable:
    """Returns ``train_step(state, batch, seed) -> metrics``: one update of
    ``state`` (in place) on ``batch`` (the objective's batch dict, tensors
    on the model's device).  ``metrics`` holds every loss key, ``loss``
    (their sum), ``grad_norm`` (before the clip, as ``optax.global_norm``)
    and ``sca_overflow``, as tensors on the device: reading them is the
    caller's sync.

    The forward and the backward run under ``fp32_precision`` (an fp32
    model's matmuls and convolutions, cuDNN's backward ones included, in
    true fp32).  Dropout draws from the default generators, seeded with
    ``step_seed(seed, state.step)`` inside ``fork_rng``: the caller's
    generators are left as they were, and ``torch.utils.checkpoint``'s
    replay under ``remat_encoder``, which restores those generators,
    redraws the same masks.  The masks are not JAX's.

    With ``mesh`` (a ``parallel.mesh.Mesh``) ``batch`` is this rank's
    rows, and cameras, of the global batch: the forward and the losses run
    under ``data_parallel`` (global avg factors, dropout masks drawn for
    the global batch), the gradients are averaged over the world before
    the clip, and the metrics are the global batch's (the losses averaged
    over the data group, ``sca_overflow`` the world's largest).  A
    tensor-parallel ``state`` (``state.tp``, on a ``make_tp_mesh`` grid) has
    its full parameters gathered for the forward and the backward and is
    updated on its slices (``TrainState.apply_gradients``)."""

    @span("train#step")
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int) -> Dict[str, torch.Tensor]:
        model = state.model
        if state.tp is not None:
            state.tp.gather()
        dev = next(model.parameters()).device
        model.train()
        devices = [dev.index] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), \
                fp32_precision(cfg.dtype), data_parallel(mesh):
            torch.manual_seed(step_seed(seed, state.step))
            with span("train#forward"):
                outs = model(batch["features"], batch["world2pixel"],
                             batch["origin_shift"])
            with span("train#losses"):
                loss_dict = compute_losses(cfg, outs, batch,
                                           matcher=tc.matcher)
                total = sum(loss_dict.values())
            with span("train#backward"):
                state.optimizer.zero_grad(set_to_none=True)
                total.backward()
        if mesh is not None:
            allreduce_grads(mesh, model.parameters())
        with span("train#optimizer"):
            grad_norm = state.apply_gradients()
        keys = list(loss_dict)
        losses = mean_over_data(mesh, torch.stack(
            [loss_dict[k].detach() for k in keys] + [total.detach()]))
        metrics = dict(zip(keys + ["loss"], losses.unbind()))
        metrics["grad_norm"] = grad_norm
        # the sparse lift's dropped visible queries in the worst camera
        # slot, a tensor on the device (the dense lift's constant 0 too)
        overflow = torch.as_tensor(outs["sca_overflow"], device=dev)
        if mesh is not None and mesh.distributed:
            overflow = overflow.clone()
            dist.all_reduce(overflow, op=dist.ReduceOp.MAX,
                            group=mesh.world_group)
        metrics["sca_overflow"] = overflow
        return metrics

    return train_step
