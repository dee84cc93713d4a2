"""A cell of ``BENCHMARK.json`` cut to ``configs/verformer/vocc_tiny.py``'s
widths and a small pool, for runs on the CPU."""

from __future__ import annotations

import time
from pathlib import Path

from verbench import bench

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(bev_z=2, bev_h=4, bev_w=4, occupancy_size=[1.5, 1.5, 0.4375],
            num_query=12, occ_dims=16, embed_dims=32, in_channels=32,
            ffn_dim=64, encoder_layers=1, decoder_layers=2, feat_h=4,
            feat_w=4)
TRAFFIC = dict(pool=8, cycles=4, pass_volumes=4, check_volumes=2,
               warmup_volumes=2, check_batches=2, check_among=3)


def cell(workload: str, **model) -> bench.Cell:
    c = bench.Cell(ROOT, workload)
    cams = 4 if c.arch.num_cams > 6 else 2
    cap = 24 if c.arch.sca_query_capacity else 0
    c.config["model"].update(TINY, num_cams=cams, sca_query_capacity=cap)
    c.config["model"].update(model)
    c.arch = bench.arch_of(c.config)
    for k, v in TRAFFIC.items():
        if k in c.traffic or k == "pool":
            c.traffic[k] = v
    if c.traffic.get("batch", 1) > 1:
        c.traffic["batch"] = 2
    return c


def run(workload: str, seed: int = 3, **model) -> dict:
    """One CPU run of the tiny cell."""
    c = cell(workload, **model)
    return bench.run_cell(ROOT, workload, seed, 0.3, False, "cpu",
                          time.perf_counter(), cell=c)
