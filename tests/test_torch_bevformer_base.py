"""BEVFormer-base through the port: ``models/bev2d.py`` at upstream's
settings (several FPN levels, ``fpn_inputs``, can-bus, shift and
rotation, the sparse lift) and its video entry ``forward_test``, held
against the benchmark's plain reference (``verbench/reference/
bevformer.py``) at a small size on the CPU; the multi-level plain path;
the rule that sends a CUDA call to the staged or the gather kernel."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from verbench.drivers.bev_video import build_model, rig, scenes
from verbench.reference import bevformer as refmod
from vln_ver_tpu_torch import geometry
from vln_ver_tpu_torch.models.bev2d import VideoState
from vln_ver_tpu_torch.ops import deform_cuda
from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d

SMALL = dict(bev_h=8, bev_w=8, embed_dims=32, num_heads=4,
             encoder_layers=2, decoder_layers=2, ffn_dim=64, num_query=12,
             num_points_in_pillar=4, sca_num_points=8, tsa_num_points=4,
             decoder_num_points=4, num_levels=2, num_cams=2, feat_h=8,
             feat_w=16, in_channels=32, canbus_dims=18,
             pc_range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0],
             feat_shapes=[[8, 16], [4, 8]], fpn_inputs=True,
             sca_query_capacity=0, image_wh=[1600.0, 928.0], use_shift=True,
             use_can_bus=True, can_bus_norm=True, rotate_prev_bev=True,
             dropout_rate=0.1, dtype="float32")
RIG = {"image_size": [1600, 900], "yaw_deg": [0.0, 180.0],
       "fov_deg": [70.0, 110.0], "radius_m": 1.0, "height_m": -0.3}
TRAFFIC = dict(scenes=2, scene_frames=3, pool=3, step_m=[0.0, 7.0],
               yaw_step_deg=5.0)


def _arch(**model):
    return refmod.Arch({"model": dict(SMALL, **model), "rig": RIG,
                        "head": {"num_classes": 10, "code_size": 10},
                        "reference": {"layer_norm_eps": 1e-6}})


def _feats(a, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((1, a.num_cams, h, w, a.embed_dims), generator=g)
            for h, w in a.level_shapes]


def _capacity(a):
    return geometry.max_visible_queries(
        rig(a), np.zeros((1, 3), np.float32), 0, a.bev_h, a.bev_w,
        a.pc_range, a.image_wh, pillar_anchors=a.num_points_in_pillar)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_port_matches_reference_over_a_scene_and_a_reset(sparse):
    """Three frames of a scene (``prev_bev`` carried, can-bus deltas, the
    shift and the rotation), then the first frame of the next: bev_embed,
    every layer's class scores and boxes within fp32 rounding of the
    reference's own video state."""
    a = _arch()
    if sparse:
        a = _arch(sca_query_capacity=_capacity(a))
        assert 0 < a.sca_query_capacity < a.bev_num
    w = refmod.make_weights(a, 11, "cpu")
    model = build_model(a, w, "cpu")
    ref = refmod.Video(refmod.Ref(a, w))
    state = VideoState()
    _, can_bus = scenes(5, TRAFFIC)
    w2p = torch.from_numpy(rig(a))
    plan = [(0, 0), (0, 1), (0, 2), (1, 0)]
    with torch.no_grad():
        for i, (s, k) in enumerate(plan):
            feats = _feats(a, 100 + i)
            got = model.forward_test(
                {"features": feats, "world2pixel": w2p,
                 "origin_shift": torch.zeros((1, 3)),
                 "can_bus": can_bus[s, k], "scene_token": s}, state)
            want = ref.frame(feats, w2p, can_bus[s, k], s)
            assert (state.prev_pos == can_bus[s, k, :3]).all()
            assert int(got["sca_overflow"]) == 0
            for key in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
                torch.testing.assert_close(got[key], want[key], rtol=1e-4,
                                           atol=2e-5, msg=f"{key} {s},{k}")


def test_a_new_scene_drops_prev_bev_and_zeroes_the_deltas(monkeypatch):
    """The can-bus the model sees: 0 in [:3] and [-1] at a scene's start,
    the deltas from the previous frame after it, and no ``prev_bev`` at a
    new scene."""
    a = _arch()
    model = build_model(a, refmod.make_weights(a, 3, "cpu"), "cpu")
    seen = []

    def forward(features, w2p, shift, can_bus=None, prev_bev=None):
        seen.append((can_bus.clone(), prev_bev is not None))
        return {"bev_embed": torch.zeros((1, a.bev_num, a.embed_dims))}

    monkeypatch.setattr(model, "forward", forward)
    _, cb = scenes(9, TRAFFIC)
    state = VideoState()
    for s, k in ((0, 0), (0, 1), (0, 2), (1, 0)):
        model.forward_test({"features": None, "world2pixel": torch.zeros(1),
                            "origin_shift": None, "can_bus": cb[s, k],
                            "scene_token": s}, state)
    assert [p for _, p in seen] == [False, True, True, False]
    for (c, _), (s, k) in zip(seen, ((0, 0), (0, 1), (0, 2), (1, 0))):
        want = cb[s, k].copy()
        if k:
            want[:3] -= cb[s, k - 1, :3]
            want[-1] -= cb[s, k - 1, -1]
        else:
            want[:3] = want[-1] = 0.0
        np.testing.assert_allclose(c[0].numpy(), want.astype(np.float32),
                                   rtol=1e-6, atol=1e-4)


def test_multi_level_plain_path_is_a_per_level_grid_sample_sum():
    shapes = ((6, 10), (3, 5), (2, 3))
    bs, heads, d, nq, P = 2, 3, 4, 7, 5
    g = torch.Generator().manual_seed(2)
    rows = sum(h * w for h, w in shapes)
    value = torch.randn((bs, rows, heads, d), generator=g)
    loc = torch.rand((bs, nq, heads, len(shapes), P, 2), generator=g) \
        * 1.2 - 0.1
    wgt = torch.rand((bs, nq, heads, len(shapes), P), generator=g)
    got = ms_deform_attn_2d(value, shapes, loc, wgt)
    want = torch.zeros((bs, heads, d, nq))
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
            bs * heads, d, h, w)
        start += h * w
        grid = (2 * loc[:, :, :, lvl] - 1).transpose(1, 2).flatten(0, 1)
        taps = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)       # (bs*H, d, nq, P)
        wl = wgt[:, :, :, lvl].transpose(1, 2).reshape(bs * heads, 1, nq, P)
        want += (taps * wl).sum(-1).view(bs, heads, d, nq)
    want = want.permute(0, 3, 1, 2).reshape(bs, nq, heads * d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# the shapes the VoxelFormer cells launch (ver36: 36 views in bf16; vocc:
# 6 in fp32; 8 heads of 96 over 14 x 14 ViT patches) and BEV2DConfig's
# defaults (14 x 14 features, a 15 x 15 BEV, 8 heads of 32)
STAGED_SHAPES = [(((14, 14),), 96, 2), (((14, 14),), 96, 4),
                 (((15, 15),), 96, 4), (((14, 14),), 32, 4),
                 (((15, 15),), 32, 4)]
BASE_LEVELS = ((116, 200), (58, 100), (29, 50), (15, 25))
GATHER_SHAPES = [(BASE_LEVELS, 32, 4), (BASE_LEVELS, 32, 2),
                 (((200, 200),), 32, 4), (((116, 200),), 32, 4),
                 (((14, 14), (7, 7)), 96, 4)]


@pytest.mark.parametrize("shapes, d, elt", STAGED_SHAPES)
def test_the_cells_shapes_stay_on_the_staged_kernel(shapes, d, elt):
    (h, w), = shapes
    assert deform_cuda.route(shapes, d, elt) == deform_cuda.STAGED
    deform_cuda.plan_launch(6, 8, 900, h * w, d, elt, 132)


@pytest.mark.parametrize("shapes, d, elt", GATHER_SHAPES)
def test_several_levels_and_large_maps_take_the_gather_kernel(shapes, d,
                                                              elt):
    assert deform_cuda.route(shapes, d, elt) == deform_cuda.GATHER_ROUTE
    if len(shapes) == 1:
        (h, w), = shapes
        with pytest.raises(ValueError, match="shared memory"):
            deform_cuda.plan_launch(2, 8, 900, h * w, d, elt, 132)
    plan = deform_cuda.plan_gather(6, 8, 12608, len(shapes), d, elt, 132)
    per_block = deform_cuda.GATHER_WARPS * plan.items_per_warp
    assert plan.items == 6 * 12608 * 8
    assert (plan.blocks - 1) * per_block < plan.items <= \
        plan.blocks * per_block


def test_gather_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="even head_dim"):
        deform_cuda.plan_gather(1, 8, 10, 4, 33, 2, 132)
    with pytest.raises(ValueError, match="levels"):
        deform_cuda.plan_gather(1, 8, 10, 17, 32, 4, 132)
    with pytest.raises(ValueError, match="head_dim"):
        deform_cuda.plan_gather(1, 8, 10, 4, 512, 4, 132)
    small = deform_cuda.plan_gather(1, 8, 900, 1, 32, 4, 132)
    assert small.items_per_warp == 1 and small.blocks == 900


def test_pillar_capacity_counts_what_the_lift_sees():
    """``max_visible_queries`` over pillars is never below the lift's own
    count of the (camera, query) pairs with a visible anchor."""
    a = _arch(bev_h=40, bev_w=40)
    w2p = rig(a)
    need = geometry.max_visible_queries(
        w2p, np.zeros((1, 3), np.float32), 0, a.bev_h, a.bev_w, a.pc_range,
        a.image_wh, pillar_anchors=a.num_points_in_pillar)
    pillars = geometry.pillar_reference_points(
        a.bev_h, a.bev_w, a.num_points_in_pillar,
        z_extent=a.pc_range[5] - a.pc_range[2])
    _, mask = geometry.project_reference_points(
        pillars.reshape(-1, 3), torch.from_numpy(w2p), torch.zeros((1, 3)),
        pc_range=a.pc_range, image_wh=a.image_wh)
    seen = mask.reshape(1, a.num_cams, a.bev_num, -1).any(-1).sum(-1)
    assert int(seen.max()) <= need <= int(seen.max()) + 8
