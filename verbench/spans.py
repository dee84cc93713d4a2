"""Spans of the benchmark's own: CUDA events recorded at the boundaries
of the program's layers, from forward hooks and wrappers that the
benchmark installs on the objects it drives (the program holds no spans
of its own yet).  Events are only recorded during the window and read
once it has closed, so the window has no extra synchronisation.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch


class Spans:
    """Marks named points on the current stream; ``span_ms(a, b)`` sums
    the device time from each mark ``a`` to the next mark ``b``."""

    def __init__(self):
        self.marks: List[Tuple[str, torch.cuda.Event]] = []
        self.active = False
        self._undo = []

    def mark(self, name: str) -> None:
        if self.active:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    def on_module(self, module, before: str = None, after: str = None):
        """Mark ``before`` when ``module`` is called and ``after`` when it
        returns."""
        if before:
            self._undo.append(module.register_forward_pre_hook(
                lambda *_: self.mark(before)).remove)
        if after:
            self._undo.append(module.register_forward_hook(
                lambda *_: self.mark(after)).remove)

    def on_call(self, obj, attr: str, before: str = None, after: str = None):
        """Wrap the attribute ``attr`` of ``obj`` to mark around calls."""
        inner = getattr(obj, attr)

        def call(*a, **k):
            if before:
                self.mark(before)
            out = inner(*a, **k)
            if after:
                self.mark(after)
            return out
        had = attr in vars(obj)
        setattr(obj, attr, call)
        self._undo.append(lambda: setattr(obj, attr, inner) if had
                          else delattr(obj, attr))
        return call

    @contextlib.contextmanager
    def recording(self):
        self.active = True
        try:
            yield self
        finally:
            self.active = False

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def span_ms(self, start: str, end: str) -> Tuple[float, int]:
        """(total device ms, spans) from each ``start`` mark to the first
        ``end`` mark after it."""
        torch.cuda.synchronize()
        total, n, open_ev = 0.0, 0, None
        for name, ev in self.marks:
            if name == start:
                open_ev = ev
            elif name == end and open_ev is not None:
                total += open_ev.elapsed_time(ev)
                n += 1
                open_ev = None
        return total, n

    def summary(self, pairs: Dict[str, Tuple[str, str]]) -> Dict[str, float]:
        """{span: device ms per occurrence} of each (start, end) pair that
        occurred."""
        out = {}
        for key, (start, end) in pairs.items():
            total, n = self.span_ms(start, end)
            if n:
                out[key] = total / n
        return out
