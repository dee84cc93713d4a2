"""Readings that the limits of ``verbench/limits/<workload>.json`` are set
from, in one process (a cell's set-up is long):

    python -m verbench.calibrate --workload <name> --seeds 11,12,... \
        --control-seeds 21,22,23 [--seconds 2] [--out FILE]

For each of ``--seeds``: the program's numbers, as a run compares them,
after a short window at the cell's own load.  For each of
``--control-seeds``: the control's numbers, the plain reference computed
in the nearest precision below the configuration's
(``compare.control_precision``) in the program's place.  One JSON line
each; with ``--out`` appended to that file too.  Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from .bench import Cell, env_for_caches
from .compare import control_precision


def readings(cell, seed, seconds, control=None, device="cuda:0"):
    d = cell.driver(seed, device)
    if control is None:
        d.setup()
        d.run_window(seconds)
        d.release()
        nums = d.check()
    else:
        d.plan()
        nums = d.check(control=control)
    out = {"workload": cell.name, "seed": seed,
           "side": control or "program", "failed": d.failed,
           "numbers": {n["name"]: n["value"] for n in nums},
           "beside": {k: v for k, v in d.counters.items()
                      if k not in ("batch",)}}
    del d
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m verbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    root = Path.cwd()
    env_for_caches(root)
    if not torch.cuda.is_available():
        print("verbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(root, args.workload)
    control = control_precision(cell.arch.dtype)
    jobs = [(int(s), None) for s in args.seeds.split(",") if s]
    jobs += [(int(s), control) for s in args.control_seeds.split(",") if s]
    for seed, ctl in jobs:
        line = json.dumps(readings(cell, seed, args.seconds, ctl))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
