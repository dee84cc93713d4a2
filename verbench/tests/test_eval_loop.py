"""``vocc-eval-b2``: ``test.py``'s per-batch work on the ``vocc``
configuration at batch 2, a tiny run on the CPU (correct, the decode and
histograms run every batch, and not correct when the occupancy logits are
a thousandth off)."""

import json
import time


from verbench import bench

from . import tiny

CELL = "vocc-eval-b2"


def test_entry():
    spec = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("vocc", "eval-pool64-b2", 1)
    c = bench.Cell(tiny.ROOT, CELL)
    assert c.traffic["batch"] == 2 and c.arch.dtype == "float32"
    assert c.traffic["occ_thresholds"] == [0.25]
    assert [m["name"] for m in c.end_to_end] == ["volumes_per_s",
                                                 "setup_s"]
    assert [m["name"] for m in c.per_layer] == [
        "encoder_span_ms.eval", "decoder_span_ms.eval",
        "occupancy_span_ms.eval", "mfu.eval", "device_idle.eval"]


def test_tiny_run_is_correct_and_folds_the_histograms():
    seen = {}
    c = tiny.cell(CELL)
    make = c.driver

    def driver(seed, device):
        seen["driver"] = make(seed, device)
        return seen["driver"]
    c.driver = driver
    out = bench.run_cell(tiny.ROOT, CELL, 2 ** 31 + 77, 1.0, False, "cpu",
                         time.perf_counter(), cell=c)
    assert out["correct"] and out["failed"] == 0, out
    assert set(out["checks"]) == {"bev_embed", "cls_scores", "bbox_preds",
                                  "occupancy"}
    d = seen["driver"]
    hist = d.ssc.hist
    calls = out["attempted"] // 2 + int(c.traffic["warmup_calls"])
    voxels = d.arch.occ_zdim * d.arch.occ_ydim * d.arch.occ_xdim
    assert hist.sum() == calls * 2 * voxels


def test_logits_off_by_a_thousandth_are_not_correct(monkeypatch):
    from vln_ver_tpu_torch.models.detector import VoxelFormer
    forward = VoxelFormer.forward

    def scaled(self, *a, **k):
        out = dict(forward(self, *a, **k))
        out["occupancy_preds"] = out["occupancy_preds"] * 1.001
        return out
    monkeypatch.setattr(VoxelFormer, "forward", scaled)
    assert not tiny.run(CELL)["correct"]
