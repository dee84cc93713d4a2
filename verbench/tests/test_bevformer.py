"""The BEVFormer-base cell: its configuration, its entries in
``BENCHMARK.json``, a tiny run on the CPU (correct, and not correct when
the program is broken), its FLOP and byte formulas and its readers."""

from __future__ import annotations

import json
import time
import types

import numpy as np
import pytest

from verbench import bench, bevformer_flops
from verbench.drivers.bev_video import rig, scenes
from verbench.reference import bevformer as refmod

from . import tiny

CELL = "bevformer-base-video-b1"
SPEC = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
# the cut of tests/test_torch_bevformer_base.py: 2 levels, an 8 x 8 BEV,
# 2 + 2 layers, 2 cameras
SMALL = dict(bev_h=8, bev_w=8, embed_dims=32, num_heads=4,
             encoder_layers=2, decoder_layers=2, ffn_dim=64, num_query=12,
             num_levels=2, num_cams=2, feat_h=8, feat_w=16, in_channels=32,
             feat_shapes=[[8, 16], [4, 8]])
TRAFFIC = dict(pool=4, scene_frames=5, scenes=3, warmup_frames=2)
PER_LAYER = ["msda_roofline.bev", "tsa_span_ms.bev", "sca_span_ms.bev",
             "bev_decoder_span_ms.bev", "temporal_share.bev",
             "lift_slot_use.bev", "mfu.bev", "device_idle.bev"]


def _cell(capacity=0):
    c = bench.Cell(tiny.ROOT, CELL)
    c.config["model"].update(SMALL, sca_query_capacity=capacity)
    c.arch = bench.arch_of(c.config)
    c.traffic.update(TRAFFIC)
    return c


def _run(capacity=0, seed=2 ** 31 + 12345):
    return bench.run_cell(tiny.ROOT, CELL, seed, 0.3, False, "cpu",
                          time.perf_counter(), cell=_cell(capacity))


def test_entries():
    w = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert w["chips"] == 1 and w["config"] == "bevformer-base"
    config = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert config["reduced"] == ["img_backbone", "img_neck"]
    mine = [m["name"] for m in SPEC["per_layer"]
            if CELL in m.get("workloads", [])]
    assert mine == PER_LAYER
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if CELL in m.get("workloads", [CELL])]
    assert e2e == ["volumes_per_s", "setup_s"]
    cell = bench.Cell(tiny.ROOT, CELL)
    assert type(cell.arch) is refmod.Arch
    assert [m["name"] for m in cell.per_layer] == PER_LAYER


def test_configuration_keeps_the_published_widths():
    a = bench.Cell(tiny.ROOT, CELL).arch
    assert (a.embed_dims, a.num_heads, a.ffn_dim, a.num_query) == \
        (256, 8, 512, 900)
    assert (a.bev_h, a.bev_w, a.encoder_layers, a.decoder_layers) == \
        (200, 200, 6, 6)
    assert a.level_shapes == ((116, 200), (58, 100), (29, 50), (15, 25))
    assert (a.sca_num_points, a.tsa_num_points, a.decoder_num_points,
            a.num_points_in_pillar) == (8, 4, 4, 4)
    assert a.value_rows == 30825 and a.dtype == "float32"


def test_capacity_is_the_rigs_rounded_up():
    """No visible query of the rig is dropped: the capacity is the most
    visible pillars of any camera, rounded up to 64."""
    from vln_ver_tpu_torch.geometry import max_visible_queries
    a = bench.Cell(tiny.ROOT, CELL).arch
    need = max_visible_queries(rig(a), np.zeros((1, 3), np.float32), 0,
                               a.bev_h, a.bev_w, a.pc_range, a.image_wh,
                               pillar_anchors=a.num_points_in_pillar)
    assert a.sca_query_capacity == -(-need // 64) * 64


def test_scenes_are_seeded_and_move_as_stated():
    t = bench.Cell(tiny.ROOT, CELL).traffic
    o1, cb1 = scenes(2 ** 31 + 7, t)
    o2, cb2 = scenes(2 ** 31 + 7, t)
    assert (o1 == o2).all() and (cb1 == cb2).all()
    assert o1.shape == (t["scenes"], t["scene_frames"])
    assert all(sorted(row) == list(range(t["pool"])) for row in o1)
    step = np.linalg.norm(np.diff(cb1[:, :, :3], axis=1), axis=-1)
    assert step.min() >= 0.0 and step.max() <= 7.0
    turn = (np.diff(cb1[:, :, -1], axis=1) + 180.0) % 360.0 - 180.0
    assert np.abs(turn).max() <= 5.0 + 1e-9
    np.testing.assert_allclose(np.radians(cb1[..., -1]), cb1[..., -2])


@pytest.mark.parametrize("capacity", [0, 40], ids=["dense", "sparse"])
def test_tiny_run_is_correct(capacity):
    out = _run(capacity)
    assert out["correct"] and out["failed"] == 0, out
    assert out["attempted"] >= TRAFFIC["scene_frames"]
    assert set(out["checks"]) == {"bev_embed", "cls_scores", "bbox_preds"}
    assert set(out["metrics"]) == {"volumes_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["no_rotation", "no_prev_bev"])
def test_a_broken_program_is_not_correct(fault, monkeypatch):
    """The check sees a frame that is not rotated into the ego's pose, and
    one that forgets the previous BEV."""
    from vln_ver_tpu_torch.models import bev2d
    if fault == "no_rotation":
        monkeypatch.setattr(bev2d, "rotate_bev",
                            lambda bev, angle, h, w: bev)
    else:
        test = bev2d.BEVFormer2D.forward_test

        def forgetful(self, frame, state):
            state.scene_token = object()
            return test(self, frame, state)
        monkeypatch.setattr(bev2d.BEVFormer2D, "forward_test", forgetful)
    assert not _run()["correct"]


def test_formulas():
    a = bench.Cell(tiny.ROOT, CELL).arch
    launches = bevformer_flops.msda_launches(a)
    assert len(launches) == 18
    sca = launches[1]
    assert (sca.bs, sca.rows, sca.nq, sca.levels, sca.points) == \
        (6, 30825, 12608, 4, 8)
    # the lift reads its whole value; the decoder's 900 queries only their
    # taps' rows
    assert bevformer_flops.msda_bytes(sca) > 6 * 30825 * 256 * 4
    dec = launches[-1]
    assert bevformer_flops.msda_bytes(dec) < 200 * 200 * 256 * 4
    assert 5e11 < bevformer_flops.frame_flop(a) < 8e11


def test_readers_read_nothing_where_there_is_nothing():
    run = types.SimpleNamespace(trace=None, counters={}, spans={})
    for name in ("msda_roofline.bev", "temporal_share.bev"):
        assert bench.Cell(tiny.ROOT, CELL).reader(name)(run) is None

    class Trace:
        def kernel_s(self, name):
            assert name == "msda_gather_kernel"
            return 0.9, 36

    run = types.SimpleNamespace(trace=Trace(), counters={
        "msda_launches_per_frame": 18, "msda_least_s_per_frame": 0.045})
    share = bench.Cell(tiny.ROOT, CELL).reader("msda_roofline.bev")(run)
    assert share == pytest.approx(100.0 * 0.045 * 2 / 0.9)


@pytest.mark.gpu
def test_tf32_control_fails_at_cell_size():
    """The reference with TF32 on, in the program's place, fails a limit
    on three seeds, as the limits were set."""
    import torch

    from verbench import calibrate
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = bench.Cell(tiny.ROOT, CELL)
    for seed in (401, 402, 403):
        out = calibrate.readings(cell, seed, 1.0, control="tf32")
        assert any(v > cell.limits[k] for k, v in out["numbers"].items()), \
            out
