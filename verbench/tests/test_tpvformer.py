"""The TPVFormer cell: its configuration, its entries in
``BENCHMARK.json``, a tiny run on the CPU (correct, and not correct when
the program is broken), its FLOP formulas and its readers."""

from __future__ import annotations

import json
import time
import types

import pytest

from verbench import bench, tpvformer_flops
from verbench.reference import tpvformer as refmod

from . import tiny

CELL = "tpvformer-occ-b1"
SPEC = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
# the cut of tests/test_torch_tpvformer.py
SMALL = dict(tpv_h=4, tpv_w=4, tpv_z=2, embed_dims=32, num_heads=4,
             pos_dims=[12, 12, 8], ffn_dim=64, num_levels=2, num_cams=2,
             feat_shapes=[[8, 16], [4, 8]], num_points_in_pillar=[4, 8, 8],
             num_points=[8, 16, 16], hybrid_anchors=4, hybrid_points=8,
             hidden_dims=64)
RIG = {"image_size": [1600, 900], "yaw_deg": [0.0, 180.0],
       "fov_deg": [70.0, 110.0], "radius_m": 1.0, "height_m": -0.3}
TRAFFIC = dict(pool=4, cycles=3, warmup_frames=2, check_among=2)
PER_LAYER = ["hybrid_span_ms.tpv", "ica_span_ms.tpv",
             "aggregate_span_ms.tpv", "lift_slot_use.tpv",
             "msda_roofline.tpv", "mfu.tpv", "device_idle.tpv"]


def _cell(capacity=0):
    c = bench.Cell(tiny.ROOT, CELL)
    c.config["model"].update(SMALL, ica_query_capacity=capacity)
    c.config["rig"] = RIG
    c.arch = bench.arch_of(c.config)
    c.traffic.update(TRAFFIC)
    return c


def _run(capacity=0, seed=2 ** 31 + 4321):
    return bench.run_cell(tiny.ROOT, CELL, seed, 1.0, False, "cpu",
                          time.perf_counter(), cell=_cell(capacity))


def test_entries():
    w = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert w["chips"] == 1 and w["config"] == "tpvformer-occ"
    config = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert config["reduced"] == ["img_backbone", "img_neck"]
    cell = bench.Cell(tiny.ROOT, CELL)
    assert type(cell.arch) is refmod.Arch
    assert [m["name"] for m in cell.per_layer] == PER_LAYER
    assert [m["name"] for m in cell.end_to_end] == ["volumes_per_s",
                                                    "setup_s"]
    assert len(SPEC["workloads"]) == 7
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("capacity", [0, 30], ids=["dense", "sparse"])
def test_tiny_run_is_correct(capacity):
    out = _run(capacity)
    assert out["correct"] and out["failed"] == 0, out
    assert set(out["checks"]) == {"tpv_hw", "tpv_zh", "tpv_wz", "logits"}
    assert set(out["metrics"]) == {"volumes_per_s", "setup_s"}


def test_a_lift_too_small_fails_its_frames():
    out = _run(capacity=24)
    assert out["failed"] == out["attempted"] > 0 and not out["correct"]


@pytest.mark.parametrize("fault", ["planes", "softplus"])
def test_a_broken_program_is_not_correct(fault, monkeypatch):
    """The check sees hybrid weights that ignore the levels' logits, and
    an aggregator with ReLU for Softplus."""
    from vln_ver_tpu_torch.models import tpv
    if fault == "planes":
        monkeypatch.setattr(
            tpv, "hybrid_weights",
            lambda x: (x[..., :-1].softmax(-1) / 3).contiguous())
    else:
        monkeypatch.setattr(tpv.nn, "Softplus", tpv.nn.ReLU)
    assert not _run()["correct"]


def test_formulas():
    a = bench.Cell(tiny.ROOT, CELL).arch
    launches = tpvformer_flops.msda_launches(a)
    assert len(launches) == 8
    cvha, ica = launches[0], launches[1]
    assert (cvha.bs, cvha.rows, cvha.d, cvha.nq, cvha.levels,
            cvha.points) == (1, 11600, 16, 11600, 3, 32)
    assert (ica.bs, ica.rows, ica.d, ica.nq, ica.levels, ica.points) == \
        (6, 30825, 16, 12544, 4, 8)
    assert 1.4e11 < tpvformer_flops.frame_flop(a) < 1.8e11


def test_readers_read_nothing_where_there_is_nothing():
    run = types.SimpleNamespace(trace=None, counters={}, spans={})
    for name in PER_LAYER:
        if name.startswith(("mfu", "device_idle")):
            continue
        assert bench.Cell(tiny.ROOT, CELL).reader(name)(run) is None
