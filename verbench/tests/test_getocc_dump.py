"""``getocc-dump-b4``: get_occ.py's dump on the ``vocc`` configuration at
batch 4, a tiny run on the CPU (correct, and not correct when the
written volumes are a thousandth off)."""

import json

import vln_ver_tpu_torch.get_occ as get_occ
from verbench import bench

from . import tiny

CELL = "getocc-dump-b4"


def test_entry():
    spec = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("vocc", "dump-pool64-b4", 1)
    c = bench.Cell(tiny.ROOT, CELL)
    assert c.traffic["batch"] == 4 and c.arch.dtype == "float32"
    assert c.arch.num_cams == 6 and c.arch.sca_query_capacity == 0
    assert [m["name"] for m in c.end_to_end] == ["dump_volumes_per_s",
                                                 "setup_s"]


def test_tiny_run_is_correct():
    out = tiny.run(CELL)
    assert out["correct"] and out["failed"] == 0, out


def test_volumes_off_by_a_thousandth_are_not_correct(monkeypatch):
    make = get_occ.make_bev_only

    def scaled(model, vit=None):
        inner = make(model, vit)

        def bev_only(*a):
            bev, ovf = inner(*a)
            return bev * 1.001, ovf
        return bev_only
    monkeypatch.setattr(get_occ, "make_bev_only", scaled)
    assert not tiny.run(CELL)["correct"]
