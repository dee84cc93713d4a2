"""One optimizer update of the agent's trainers (``train_vln`` and
``pretrain_vln``), as the JAX CLIs take it: ``optax.chain(
clip_by_global_norm(40), adamw(lr))``.

optax's ``adamw`` defaults to b1 0.9, b2 0.999, eps 1e-8 and a weight decay
of 1e-4 on *every* parameter (no mask) at a constant learning rate;
``torch.optim.AdamW``'s default decay is 0.01.  The clip and AdamW are
``train.state.TrainState``'s (optax's ``g * clip / max(gnorm, clip)``, a
zero gradient for a parameter autograd left without one, so that AdamW
decays it as optax does), with a flat schedule.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ..parallel.mesh import allreduce_grads, data_parallel, mean_over_data
from ..train.state import TrainConfig, TrainState, create_train_state

CLIP_NORM = 40.0
WEIGHT_DECAY = 1e-4   # optax.adamw's default


def make_train_state(model: nn.Module, lr: float) -> TrainState:
    """AdamW (optax's defaults, constant ``lr``) behind a global-norm clip
    of 40 over every parameter of ``model``."""
    return create_train_state(model, TrainConfig(
        learning_rate=lr, weight_decay=WEIGHT_DECAY, warmup_steps=0,
        min_lr_ratio=1.0, grad_clip_norm=CLIP_NORM))


def update(state: TrainState,
           loss_fn: Callable[[], Tuple[torch.Tensor, Dict]], mesh=None):
    """``loss_fn() -> (total, parts)``, its backward, the clip and one AdamW
    step; returns (total, parts, the gradient's global norm before the
    clip), as tensors.

    With ``mesh`` (an ``(N, 1)`` ``parallel.mesh.Mesh``) the batch behind
    ``loss_fn`` is this rank's rows of the global batch: the loss runs
    under ``parallel.mesh.data_parallel`` (global means, masks drawn for
    the global batch), the gradients are averaged over the ranks before
    the clip, and the returned losses are the global batch's."""
    state.optimizer.zero_grad(set_to_none=True)
    with data_parallel(mesh):
        total, parts = loss_fn()
        total.backward()
    if mesh is not None:
        allreduce_grads(mesh, state.model.parameters())
    gnorm = state.apply_gradients()
    keys = list(parts)
    losses = mean_over_data(mesh, torch.stack(
        [total.detach()] + [parts[k].detach() for k in keys]))
    return losses[0], dict(zip(keys, losses[1:].unbind())), gnorm
