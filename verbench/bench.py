"""One run of one cell, driven by ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration (its ``file``), a
traffic mix (``verbench/traffic/<traffic>.json``, whose ``driver`` names
``verbench/drivers/<driver>.py``) and has its limits in
``verbench/limits/<workload>.json``.  Every metric has a reader,
``verbench/metrics/<metric>.py``, with ``read(run) -> float | None``; a
metric without a file of its own is read by the one its cells share,
``verbench/metrics/<metric up to the first dot>.py``.  The configuration
names its architecture module, ``verbench/reference/<arch>.py``
(:func:`arch_of`).

The run: set-up (weights and inputs from the seed, the program built and
warmed up at the cell's shapes), the measured window (traced with
``--trace 1``), the program's state freed, the plain reference over the
sample of the window's results, the metrics, one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vln_ver_tpu")
# readers that hold a kernel against flops.deform_least_s, which takes the
# VoxelFormer's lift shapes: only cells that reference/arch.py reads may
# list them
VOXELFORMER_READERS = ("deform_fwd_roofline", "deform_bwd_roofline")


def _load(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(rows: List[Dict], name: str, what: str) -> Dict:
    for row in rows:
        if row["name"] == name:
            return row
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One ``workloads`` entry and everything it names."""

    def __init__(self, root: Path, workload: str):
        from .reference.arch import Arch
        self.root = Path(root)
        spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.workload = _by_name(spec["workloads"], workload, "workload")
        self.name = workload
        entry = _by_name(spec["configs"], self.workload["config"],
                         "configuration")
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.arch = arch_of(self.config)
        if type(self.arch) is not Arch:
            theirs = [m["name"] for m in spec["per_layer"]
                      if workload in m.get("workloads", [workload])
                      and reader_path(m["name"]).stem in VOXELFORMER_READERS]
            if theirs:
                raise ValueError(
                    f"{theirs} read the VoxelFormer's shapes; a cell of "
                    f"{entry['file']} (arch {self.config['arch']!r}) brings "
                    "rooflines with readers of its own")
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.limits = json.loads(
            (HERE / "limits" / f"{workload}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        mine = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if workload in m.get("workloads", [workload])
                          and m["moves"] in mine]
        self.chips = int(self.workload["chips"])

    def driver(self, seed: int, device):
        mod = _load(HERE / "drivers" / f"{self.traffic['driver']}.py",
                    f"verbench_driver_{self.traffic['driver']}")
        return mod.Driver(self, seed, device)

    def reader(self, metric: str):
        path = reader_path(metric)
        return _load(path, "verbench_metric_"
                     + path.stem.replace(".", "_")).read


def arch_of(config: Dict):
    """The architecture a configuration file describes: ``Arch(config)``
    of ``verbench/reference/<config["arch"]>.py``, of ``reference/arch.py``
    (the VoxelFormer) where the file has no ``"arch"`` key.

    The contract: an architecture module's ``Arch(spec)`` takes the file's
    object and exposes ``dtype``, a key of ``flops.PEAK_FLOP_PER_S``, which
    is all that the shared code reads of it (``readers.mfu``,
    ``calibrate``); ``driver.Driver`` hands it to the cell's own driver as
    ``self.arch``.  Everything else an architecture needs lives in files of
    its own: its reference, weights, traffic generator, driver, program
    builder, FLOP and byte formulas and metric readers.  ``program.py``,
    ``traffic.py`` and the ``deform_*_roofline`` readers are the
    VoxelFormer's.
    """
    import importlib

    from .flops import PEAK_FLOP_PER_S
    name = config.get("arch", "arch")
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"'arch' {name!r} is not the name of a module")
    module = f"{__package__}.reference.{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise FileNotFoundError(
            f"{HERE / 'reference' / name}.py is missing: the "
            f"configuration's 'arch' {name!r} names no module of "
            "verbench/reference/") from None
    arch = mod.Arch(config)
    if arch.dtype not in PEAK_FLOP_PER_S:
        raise ValueError(f"{module}.Arch's dtype {arch.dtype!r} is not one "
                         f"of {sorted(PEAK_FLOP_PER_S)}")
    return arch


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, else ``metrics/<metric up to the first
    dot>.py``, the reader that the metric's cells share."""
    path = HERE / "metrics" / f"{metric}.py"
    if path.is_file():
        return path
    return HERE / "metrics" / f"{metric.split('.', 1)[0]}.py"


class Run:
    """What the metric readers read: the window's work and time, the
    spans, the trace summary and the yardstick's counts."""

    def __init__(self, cell: Cell, driver, setup_s: float, trace=None):
        self.cell, self.arch = cell, cell.arch
        self.setup_s = setup_s
        self.window_s = driver.window_s
        self.units = driver.units
        self.spans: Dict[str, float] = driver.span_ms
        self.trace = trace
        self.counters: Dict[str, float] = driver.counters
        self.flop_per_unit = driver.flop_per_unit()


def forbidden_modules() -> List[str]:
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, cell: Cell = None) -> Dict:
    """One run; returns the result line's object.  ``cell``: the cell
    already read (the tests cut it to a tiny size)."""
    import torch

    cell = cell or Cell(root, workload)
    driver = cell.driver(seed, device)
    driver.setup()
    window = seconds
    summary = None
    if trace:
        # the spans and the step's rate first, without the profiler (it
        # slows the host's launches); then the same length under it
        window = min(seconds, float(cell.traffic.get("trace_seconds",
                                                     seconds)))
        from torch.profiler import ProfilerActivity, profile
        from .trace import TraceSummary
        with driver.spans_on():
            driver.run_window(window)
        driver.read_spans()
        t0, counts = driver.t0, (driver.units, driver.window_s,
                                 driver.attempted, driver.failed)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            driver.run_window(window)
        summary = TraceSummary(prof, driver.window_s)
        del prof
        driver.t0, driver.units, driver.window_s = t0, counts[0], counts[1]
        driver.attempted += counts[2]
        driver.failed += counts[3]
    else:
        driver.run_window(window)
    setup_s = driver.t0 - t_start
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    driver.release()
    t_check = time.perf_counter()
    numbers = driver.check()
    print(f"verbench: set-up {setup_s:.3f} s, window {driver.window_s:.3f} s,"
          f" check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    from .compare import judge
    correct = judge(numbers) and driver.failed == 0
    run = Run(cell, driver, setup_s, summary)
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    out = {"correct": bool(correct), "attempted": int(driver.attempted),
           "failed": int(driver.failed), "metrics": metrics, "device": dev}
    if summary is not None:
        out["breakdown"] = summary.breakdown()
    out["checks"] = {n["name"]: {"value": n["value"], "limit": n["limit"]}
                     for n in numbers}
    return out


def print_result(out: Dict) -> None:
    """The compared numbers beside their limits on standard error, then
    the result line, its ``checks`` key last, on standard output."""
    for name, n in out["checks"].items():
        print(f"check {name}: {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def env_for_caches(root: Path) -> None:
    """Kernel and build caches of the program at fixed paths inside the
    checkout, so that only a checkout's first run builds."""
    cache = Path(root) / ".verbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def main(argv: Optional[List[str]] = None, t_start: float = None) -> int:
    import argparse
    import traceback
    p = argparse.ArgumentParser(prog="python -m verbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    env_for_caches(root)
    try:
        import torch
        need = Cell(root, args.workload).chips
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"verbench: the cell needs {need} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        out = run_cell(root, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda:0",
                       t_start or time.perf_counter())
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"verbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print_result(out)
    return 0
