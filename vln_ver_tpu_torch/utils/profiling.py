"""Profiling helpers (PyTorch port of ``vln_ver_tpu/utils/profiling.py``).

The reference's ``run_time`` decorator (models/utils/bricks.py:7-19:
``cuda.synchronize`` and a running mean) becomes :func:`timer`;
:func:`trace` wraps ``torch.profiler`` where JAX wraps ``jax.profiler``;
:func:`grad_report` is the reference's GradChecker hook
(models/hooks/hooks.py:5-12).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Mapping

import torch

_means: Dict[str, list] = defaultdict(lambda: [0.0, 0])


def _leaves(tree):
    """The tensors of a nested dict / list / tuple, dict keys in sorted
    order (the order ``jax.tree.leaves`` walks)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def force_completion(tree) -> float:
    """The sum of every tensor of ``tree``, each summed in fp32, as a host
    float: reading it waits for the work that produced them."""
    total = 0.0
    for leaf in _leaves(tree):
        total += float(leaf.float().sum())
    return total


@contextlib.contextmanager
def timer(name: str, result_tree=None, verbose: bool = True):
    """Time a block on the host clock, completion forced: on a CUDA device
    by ``torch.cuda.synchronize`` after the block, and through
    :func:`force_completion` of ``result_tree`` (or of what it returns,
    if callable) where one is given.  Prints the time and the running
    mean under ``name``, as the JAX helper does."""
    t0 = time.perf_counter()
    yield
    if result_tree is not None:
        tree = result_tree() if callable(result_tree) else result_tree
        force_completion(tree)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    acc = _means[name]
    acc[0] += dt
    acc[1] += 1
    if verbose:
        print(f"[timer] {name}: {dt*1000:.1f} ms "
              f"(mean {acc[0]/acc[1]*1000:.1f} ms over {acc[1]})")


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the CPU, and the card where
    there is one), written as a Chrome trace to ``logdir/trace.json``
    (open it in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def grad_report(grads, limit: int = 10) -> list:
    """Names of the parameters whose gradient is all zero (or absent): the
    reference's GradChecker semantics.  ``grads`` is a module (its
    parameters' ``.grad``) or a mapping of name to gradient (None for
    absent).  One device-to-host copy for all of them: the ``any()`` of
    each gradient stacked on the device, not a sync per parameter."""
    if isinstance(grads, torch.nn.Module):
        grads = {n: p.grad for n, p in grads.named_parameters()
                 if p.requires_grad}
    names = list(grads)
    present = [n for n in names if grads[n] is not None]
    nonzero = set()
    if present:
        flags = torch.stack([grads[n].detach().ne(0).any()
                             for n in present]).cpu().tolist()
        nonzero = {n for n, f in zip(present, flags) if f}
    return [n for n in names if n not in nonzero][:limit]
