"""Profiling helpers (PyTorch port of ``vln_ver_tpu/utils/profiling.py``)
and the port's recorder of its own spans and counters.

:func:`trace` wraps ``torch.profiler`` where JAX wraps ``jax.profiler``;
:func:`grad_report` is the reference's GradChecker hook
(models/hooks/hooks.py:5-12).

The recorder.  :class:`span` marks a stage of the program's work (the
encoder, the decoder, a train step's backward, the dump's writer) and
:func:`count` adds to a counter where the work is done (the lift's
visible queries, the auction's iterations).  Recording is on exactly
while a torch profiler runs in the process.  Off, a span or a count
costs a flag check and makes no CUDA event, no profiler range and no
tensor op.  While recording, a span keeps its name, its parent (the span
open on the same thread when it opened), its thread, its host start and
end from ``time.time_ns()``, the clock of the profiler's events, so that
a device row of the trace can be put down to the span open on the host
at that moment; with ``device`` and CUDA in use, a CUDA event pair on
the current stream; and it opens a ``record_function`` range of its name
in the profiler's trace.  Only the latest profiling session is kept: the
first span or count seen after the profiler was found off starts a new
recording, which :func:`recorded` reads.  The flag is
``torch.autograd.profiler``'s process-wide one, since
``torch.autograd._profiler_enabled()`` reads False on every thread but
the one that started the profiler, and the dump's writer and transfer
threads record too.

Names are ``<part>#<stage>`` (``ver#decoder``, ``train#match``, the
counter ``lift#visible_queries``).  A reduction of the trace that keeps
device work apart from the ranges the profiler draws on the device's
timeline (the benchmark's ``verbench/trace.py``) drops every event named
so, whatever the torch build, so the program's ranges never count as
device work and never name an idle gap.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Mapping, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


class _Recording:
    """One profiling session's spans and counters."""

    def __init__(self):
        self.lock = threading.Lock()
        # rows [name, parent, thread, start_ns, end_ns, event, event]
        self.spans: list = []
        self.host: dict = {}      # counter -> int or float
        self.device: dict = {}    # counter -> tensor, summed on its device
        self.read: Optional[dict] = None


class _Recorder:
    def __init__(self):
        self.latest: Optional[_Recording] = None
        self.live = False
        self.lock = threading.Lock()
        self.local = threading.local()

    def on(self) -> Optional[_Recording]:
        """The live recording, or None with the profiler off (which ends
        the session)."""
        if not _autograd_profiler._is_profiler_enabled:
            self.live = False
            return None
        if not self.live:
            with self.lock:
                if not self.live:
                    self.latest = _Recording()
                    self.live = True
        return self.latest

    def stack(self) -> list:
        """This thread's open spans, (recording, row index) each."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_RECORDER = _Recorder()


class span:
    """``with span("part#stage"):`` records the block while a profiler
    runs (module docstring), and ``@span("part#stage")`` each call of a
    function.  ``device``: also a CUDA event pair around it on the
    current stream, where CUDA is in use."""

    __slots__ = ("name", "device", "_rec", "_row", "_range")

    def __init__(self, name: str, device: bool = True):
        self.name, self.device, self._rec = name, device, None

    def __call__(self, fn):
        name, device = self.name, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, device):
                return fn(*args, **kwargs)
        return spanned

    def __enter__(self) -> "span":
        rec = _RECORDER.on()
        if rec is None:
            return self
        stack = _RECORDER.stack()
        parent = stack[-1][1] if stack and stack[-1][0] is rec else None
        row = [self.name, parent, threading.get_native_id(), time.time_ns(),
               None, None, None]
        self._range = record_function(self.name)
        self._range.__enter__()
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            row[5] = torch.cuda.Event(enable_timing=True)
            row[5].record()
        with rec.lock:
            rec.spans.append(row)
            stack.append((rec, len(rec.spans) - 1))
        self._rec, self._row = rec, row
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is None:
            return False
        row = self._row
        if row[5] is not None:
            row[6] = torch.cuda.Event(enable_timing=True)
            row[6].record()
        self._range.__exit__(*exc)
        row[4] = time.time_ns()
        _RECORDER.stack().pop()
        self._rec = self._row = self._range = None
        return False


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs: an int or
    a float, a 0-d tensor (summed on its device with no sync, read once
    by :func:`recorded`), or a callable returning one, called only while
    recording, so that a count that takes tensor ops costs none off."""
    rec = _RECORDER.on()
    if rec is None:
        return
    if callable(n):
        n = n()
    if isinstance(n, torch.Tensor):
        n = n.detach()
        with rec.lock:
            prev = rec.device.get(name)
            rec.device[name] = n if prev is None else prev + n
    else:
        with rec.lock:
            rec.host[name] = rec.host.get(name, 0) + n


def recorded() -> Optional[dict]:
    """The latest recording, None before the first: ``spans``, each a
    dict of ``name``, ``parent`` (the index in ``spans`` of the span it
    opened in, or None), ``thread`` (the native thread id), ``start_ns``
    and ``end_ns`` (``time.time_ns()``; ``end_ns`` None while open) and
    ``device_ms`` (None without an event pair); and ``counters``, name to
    float.  Synchronises once, to read the events and device counters."""
    live = _RECORDER.on()
    rec = live or _RECORDER.latest
    if rec is None:
        return None
    if rec.read is not None:
        return rec.read
    with rec.lock:
        rows, host, device = list(rec.spans), dict(rec.host), \
            dict(rec.device)
    if torch.cuda.is_initialized() and (
            any(r[5] is not None for r in rows)
            or any(t.is_cuda for t in device.values())):
        torch.cuda.synchronize()
    spans = [{"name": r[0], "parent": r[1], "thread": r[2],
              "start_ns": r[3], "end_ns": r[4],
              "device_ms": (r[5].elapsed_time(r[6]) if r[6] is not None
                            else None)} for r in rows]
    counters = {k: float(v) for k, v in host.items()}
    for k, t in device.items():
        counters[k] = counters.get(k, 0.0) + float(t)
    out = {"spans": spans, "counters": counters}
    if live is None:
        rec.read = out
    return out


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
def trace(logdir: str):
    """``torch.profiler`` over the block (the CPU, and the card where
    there is one), written as a Chrome trace to ``logdir/trace.json``
    (open it in Perfetto or ``chrome://tracing``), and the recorder's
    spans and counters of the block to ``logdir/spans.json``
    (:func:`recorded`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    _RECORDER.live = False   # the block is a session of its own
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump(recorded() or {"spans": [], "counters": {}}, f)


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
