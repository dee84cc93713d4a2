"""Inference work replayed from CUDA graphs.

A chain of many small kernels launched one by one from Python (the DETR
decoder: some 270 launches a layer) keeps the card waiting on the host.
:class:`GraphCache` runs such a chain, ``fn(*inputs)``, through a CUDA
graph captured once per input signature and replayed after that: the same
kernels in the same order, launched by one call.

It engages only where a graph can stand in for the eager call: CUDA
inputs, autograd off (``no_grad`` or ``inference_mode``), every module
the chain reads in ``eval()``, and no capture running on the current
stream.  Anywhere else (the CPU, training, a call with grad enabled, a
call inside another capture) ``fn`` runs eagerly.

The key of a graph: the inputs' shapes, strides (a static buffer keeps
a dense input's strides, so that the graph computes on the layout the
eager call would), dtypes and devices; the caller's ``static`` values
(grid shapes); whether inference mode is on, since the static buffers
made under it cannot be written outside it; the TF32 flags, which fix
cuBLAS's and cuDNN's math at capture; and the storage address of every
parameter and buffer of the modules.  Swapping a parameter's ``.data``
(tensor parallelism) therefore captures anew, while an in-place update
(``copy_``, ``load_state_dict``) keeps the addresses and the next replay
reads the new values.

A miss runs ``fn`` once on a side stream (lazy set-up: libraries, launch
plans, cuBLAS handles), captures it, and replays.  A hit copies the
inputs into the graph's static buffers and replays; neither syncs with
the host.  What leaves the graph is cloned, so outputs a caller keeps are
never overwritten by a later replay.

Host-side launch counts of hand-written kernels (``deform_cuda.KERNEL``)
count each call's launches as an eager call would: the warm-up counts
those of the capturing call, the capture itself none (the kernel's
``restore(mark)``), and each later replay counts the captured ones again
(``replayed(before, after)``, from the kernel's ``mark()`` before and
after the capture).
"""

from __future__ import annotations

import collections
from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch import nn

from .profiling import count


class _Entry(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: list          # the static input buffers
    outputs: object       # fn's outputs, written by each replay
    marks: list           # (kernel, mark before, mark after) a kernel


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _state(modules: Sequence[nn.Module]) -> Optional[tuple]:
    """The storage addresses of every parameter and buffer of
    ``modules``, or None where one of them is in training mode."""
    ptrs = []
    todo = list(modules)
    while todo:                 # cheaper than Module.modules()' names
        m = todo.pop()
        if m.training:
            return None
        for t in m._parameters.values():
            if t is not None:
                ptrs.append(t.data_ptr())
        for t in m._buffers.values():
            if t is not None:
                ptrs.append(t.data_ptr())
        todo.extend(c for c in m._modules.values() if c is not None)
    return tuple(ptrs)


def engaged(inputs: Sequence[torch.Tensor]) -> bool:
    """Whether a call on ``inputs`` may replay a graph, as far as the
    call itself says: autograd off, every input on the card, and no
    capture running on the current stream."""
    return (not torch.is_grad_enabled() and all(x.is_cuda for x in inputs)
            and not torch.cuda.is_current_stream_capturing())


def graph_key(inputs: Sequence[torch.Tensor], modules: Sequence[nn.Module],
              static=()) -> Optional[tuple]:
    """The key of the graph that stands in for a call on ``inputs``
    (module docstring), or None where one of ``modules`` is in training
    mode."""
    params = _state(modules)
    if params is None:
        return None
    return (tuple((tuple(x.shape), x.stride(), x.dtype, x.device)
                  for x in inputs),
            static, torch.is_inference_mode_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, params)


class GraphCache:
    """Up to ``SIZE`` captured graphs of one call site, least recently
    used evicted first.  ``kernels``: the hand-written kernels the chain
    may launch, whose launch counts replays keep (module docstring).
    ``name``: count ``<name>#calls`` for every call and
    ``<name>#graph_replays`` for those a graph served, in the program's
    recorder (``utils.profiling.count``)."""

    # a caller runs one shape or a few (an eval loop's last, smaller
    # batch; a server pads every batch to one size)
    SIZE = 4

    def __init__(self, kernels: Sequence = (), name: Optional[str] = None):
        self.kernels = tuple(kernels)
        self.name = name
        self.graphs: "collections.OrderedDict[tuple, _Entry]" = \
            collections.OrderedDict()

    def __call__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 modules: Sequence[nn.Module], static=()):
        """``fn(*inputs)``, replayed from a graph where one may stand in
        for it.  ``modules`` hold every parameter ``fn`` reads; ``static``
        is the hashable rest of what ``fn`` depends on."""
        if self.name:
            count(f"{self.name}#calls", 1)
        key = graph_key(inputs, modules, static) if engaged(inputs) \
            else None
        if key is None:
            return fn(*inputs)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self._capture(fn, inputs)
            self.graphs[key] = entry
            while len(self.graphs) > self.SIZE:
                self.graphs.popitem(last=False)
            # the warm-up counted this call's launches
            entry.graph.replay()
        else:
            self.graphs.move_to_end(key)
            for buf, x in zip(entry.inputs, inputs):
                buf.copy_(x)
            entry.graph.replay()
            for kernel, before, after in entry.marks:
                kernel.replayed(before, after)
        if self.name:
            count(f"{self.name}#graph_replays", 1)
        return _tree_map(torch.clone, entry.outputs)

    def _capture(self, fn, inputs) -> _Entry:
        device = inputs[0].device
        # the inputs' strides where they are dense, as the eager call's
        static = [x.clone() for x in inputs]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*static)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = [k.mark() for k in self.kernels]
        # torch.cuda.graph() without its gc.collect() and empty_cache(),
        # which only free memory for the graph and slow a large process's
        # set-up
        torch.cuda.synchronize(device)
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = fn(*static)
            finally:
                graph.capture_end()
        marks = [(k, b, k.mark()) for k, b in zip(self.kernels, before)]
        for k, b in zip(self.kernels, before):
            k.restore(b)
        return _Entry(graph, static, outputs, marks)
