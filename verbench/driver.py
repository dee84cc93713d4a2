"""What every driver (``verbench/drivers/<name>.py``) shares.

A driver builds the program for one cell from the seed, warms it up at
the cell's shapes, runs the measured window, frees the program's state
and then holds a sample of the window's results against the plain
reference.  It sets ``t0`` (the first timed call), ``window_s``,
``units`` (work completed in the window), ``attempted``, ``failed``,
``span_ms`` (device ms of each span per occurrence, traced runs) and
``counters`` (what the metric readers need besides)."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .spans import Spans


class Driver:
    span_pairs: Dict[str, tuple] = {}

    def __init__(self, cell, seed: int, device):
        self.cell, self.arch, self.traffic = cell, cell.arch, cell.traffic
        self.limits = cell.limits
        self.seed = int(seed)
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.t0 = None
        self.window_s = 0.0
        self.units = 0
        self.attempted = 0
        self.failed = 0
        self.span_ms: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self._spans = None

    # -- to be provided ------------------------------------------------------
    def plan(self) -> None:
        """What set-up and the control share: order and check sample."""
        raise NotImplementedError

    def setup(self) -> None:
        raise NotImplementedError

    def run_window(self, seconds: float) -> None:
        raise NotImplementedError

    def install_spans(self, spans: Spans) -> None:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def flop_per_unit(self) -> float:
        """FLOP of the work the path needs for one unit of ``units``
        (``verbench.flops``), for the cell's ``mfu`` metric."""
        raise NotImplementedError

    def check(self, control: str = None) -> List[Dict]:
        """The numbers compared, each with its limit (``number``); with
        ``control`` (``compare.control_precision``'s name) the reference
        in that precision takes the program's place."""
        raise NotImplementedError

    # -- shared -------------------------------------------------------------
    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def start_window(self) -> float:
        """Synchronise, then mark the first timed call."""
        self.sync()
        self.t0 = time.perf_counter()
        return self.t0

    def close_window(self) -> None:
        self.sync()
        self.window_s = time.perf_counter() - self.t0

    def settle(self) -> None:
        """After the warm-up: count the peak of device memory from here.
        The allocator keeps what the warm-up cached, so that the window
        allocates nothing new from the device."""
        self.sync()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.device)

    def free(self) -> None:
        gc.collect()
        if self.on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def spans_on(self):
        self._spans = Spans()
        self.install_spans(self._spans)
        try:
            with self._spans.recording():
                yield
        finally:
            self._spans.remove()

    def read_spans(self) -> None:
        if self._spans is not None:
            self.span_ms = self._spans.summary(self.span_pairs)
            self._spans = None

    def sample(self, n: int, among: int, salt: int) -> List[int]:
        """``n`` distinct indices below ``among``, drawn from the seed."""
        rng = np.random.default_rng([self.seed, 7919, salt])
        return sorted(int(i) for i in rng.choice(among, size=min(n, among),
                                                 replace=False))

    def number(self, name: str, value: float) -> Dict:
        return {"name": name, "value": float(value),
                "limit": float(self.limits[name])}


def valid_taps(loc: torch.Tensor, vis: torch.Tensor, h: int, w: int) -> int:
    """Bilinear taps of the lift's sampling locations that land inside
    the ``h`` x ``w`` map, over the visible (camera, query) pairs: ``loc``
    (B, N, nq, heads, points, 2) normalised (x, y), ``vis`` (B, N, nq)."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    taps = torch.zeros(loc.shape[:-1], dtype=torch.int64, device=loc.device)
    for fx in (torch.floor(x), torch.floor(x) + 1):
        for fy in (torch.floor(y), torch.floor(y) + 1):
            taps += ((fx >= 0) & (fx <= w - 1) & (fy >= 0)
                     & (fy <= h - 1)).long()
    return int((taps * vis[..., None, None].long()).sum())
