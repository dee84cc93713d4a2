"""Optimizer, schedule and train state (PyTorch port of
``vln_ver_tpu/train/state.py``).

Recipe of the reference (vocc.py:261-293): AdamW lr 1e-4, weight decay
0.01, linear warmup (ratio 1/3), cosine annealing to ``lr * min_lr_ratio``
(1e-3), global-norm gradient clip 300.  The update is the JAX package's
optax chain ``clip_by_global_norm`` -> ``adamw``:

* clip: ``g * clip / max(gnorm, clip)`` over all gradients, where optax
  writes ``select(gnorm < clip, g, g / gnorm * clip)`` (the same to
  rounding); not ``clip_grad_norm_``'s ``clip / (gnorm + 1e-6)``;
* ``torch.optim.AdamW`` with b1 0.9, b2 0.999, eps 1e-8 and decoupled
  weight decay is optax ``adamw``'s algebra; update k, counted from 0,
  takes ``lr = schedule(k)``;
* a parameter that got no gradient gets a zero gradient before the step:
  optax decays it, ``torch.optim`` would skip it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 1000
    total_steps: int = 100_000
    warmup_ratio: float = 1.0 / 3.0
    min_lr_ratio: float = 1e-3
    grad_clip_norm: float = 300.0
    # mmcv lr hooks with by_epoch=True (the reference's default) anneal
    # in epoch-granular steps; 0 keeps a smooth per-iteration anneal
    steps_per_epoch: int = 0
    matcher: str = "auction"   # 'auction' (on the device) | 'host' (scipy)
    # torch.optim.AdamW(fused=True): one kernel for all parameters, the
    # same math
    fused_opt: bool = False


def make_lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """mmcv CosineAnnealingLrUpdaterHook with linear warmup, as the JAX
    package computes it, in float32 (vln_ver_tpu/train/state.py:42-78):

    * the cosine anneals over ALL ``total_steps`` (warmup included), in
      epoch-granular progress when ``steps_per_epoch`` is set; progress is
      clamped at 1.0, so stepping past ``total_steps`` holds min_lr;
    * warmup multiplies the CURRENT annealed lr:
      ``lr = regular(t) * (1 - (1 - t/warmup) * (1 - warmup_ratio))``.
    """
    f32 = np.float32
    base, min_lr = tc.learning_rate, tc.learning_rate * tc.min_lr_ratio
    warm = f32(max(tc.warmup_steps, 1))
    spe = tc.steps_per_epoch
    total = f32(max(tc.total_steps, 1))
    half_range = f32(0.5 * (base - min_lr))

    def sched(step: int) -> float:
        t = f32(step)
        if spe > 0:
            prog = f32(np.floor(t / f32(spe)) * f32(spe)) / total
        else:
            prog = t / total
        prog = min(prog, f32(1.0))
        regular = f32(min_lr) + half_range * (
            np.cos(f32(math.pi) * prog) + f32(1.0))
        if t < tc.warmup_steps:
            k = (f32(1.0) - t / warm) * f32(1.0 - tc.warmup_ratio)
            regular = regular * (f32(1.0) - k)
        return float(regular)

    return sched


def make_optimizer(model: nn.Module, tc: TrainConfig
                   ) -> torch.optim.Optimizer:
    kw = {"fused": True} if tc.fused_opt else {}
    return torch.optim.AdamW(model.parameters(), lr=tc.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=tc.weight_decay, **kw)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of every element of ``grads``, the
    per-tensor norms in one fused call, each summed in float64, the
    result in the gradients' dtype.  An fp32 sum of squares over one large
    tensor is not accurate to fp32 on the CPU: 3.3e-4 relative over the
    9.4M elements of ``voxel2bev``'s first weight, where the card's and
    XLA's tree reductions are within 1e-6."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).to(grads[0].dtype)


@dataclasses.dataclass
class TrainState:
    """The model, its AdamW and the number of updates taken (the index of
    the next update into the schedule).  The port updates the model in
    place."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    tc: TrainConfig
    step: int = 0

    def __post_init__(self):
        self.schedule = make_lr_schedule(self.tc)

    def apply_gradients(self) -> torch.Tensor:
        """Clip the gradients the backward left on the parameters and take
        one AdamW update; returns the gradient's global norm before the
        clip (no host sync)."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        gnorm = global_norm(grads)
        clip = self.tc.grad_clip_norm
        torch._foreach_mul_(grads, clip / torch.clamp_min(gnorm, clip))
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return gnorm


def create_train_state(model: nn.Module, tc: TrainConfig) -> TrainState:
    return TrainState(model, make_optimizer(model, tc), tc)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
