"""TPVFormer's occupancy model through the port (``models/tpv.py``), held
against the benchmark's plain reference (``verbench/reference/
tpvformer.py``) at a small size on the CPU, with the sparse lift and the
dense one; the image cross-attention's grouped side-plane form against a
direct per-anchor form; the hybrid attention's factored weights; the
rule that sends TPVFormer's samplings, at head_dim 16, to the gather
kernel's narrow layout; on the card (``-m gpu``), that kernel against the
plain version at the full shapes."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from verbench.drivers.bev_video import rig
from verbench.drivers.tpv_frames import build_model
from verbench.reference import tpvformer as refmod
from vln_ver_tpu_torch import geometry
from vln_ver_tpu_torch.models import tpv
from vln_ver_tpu_torch.ops import deform_cuda
from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d

CONFIGS = Path(__file__).resolve().parents[1] / "verbench" / "configs"
SPEC = json.loads((CONFIGS / "tpvformer-occ.json").read_text())
# two of the configuration's cameras, front and back
RIG = {"image_size": [1600, 900], "yaw_deg": [0.0, 180.0],
       "fov_deg": [70.0, 110.0], "radius_m": 1.0, "height_m": -0.3}
# planes 4 x 4 x 2, 32 channels, 4 heads, 2 levels, 2 cameras, pillars
# [4, 8, 8], points [8, 16, 16], 4 anchors x 8 points, scale 2
SMALL = dict(tpv_h=4, tpv_w=4, tpv_z=2, embed_dims=32, num_heads=4,
             pos_dims=[12, 12, 8], ffn_dim=64, num_levels=2, num_cams=2,
             feat_shapes=[[8, 16], [4, 8]], num_points_in_pillar=[4, 8, 8],
             num_points=[8, 16, 16], hybrid_anchors=4, hybrid_points=8,
             hidden_dims=64, ica_query_capacity=0)
KEYS = ("tpv_hw", "tpv_zh", "tpv_wz", "logits")


def _arch(**model):
    spec = copy.deepcopy(SPEC)
    spec["model"].update(SMALL, **model)
    spec["rig"] = RIG
    return refmod.Arch(spec)


def _feats(a, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((1, a.num_cams, h, w, a.embed_dims), generator=g)
            for h, w in a.level_shapes]


def _capacity(a):
    cfg = build_model(a, refmod.make_weights(a, 0, "cpu"), "cpu").cfg
    return tpv.max_visible_slots(rig(a), cfg)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_port_matches_reference(sparse):
    """The three planes and the logits within fp32 rounding of the
    reference, over two frames; the sparse lift at the rig's capacity
    drops nothing."""
    a = _arch()
    if sparse:
        a = _arch(ica_query_capacity=_capacity(a))
        slots = sum(n * g for n, g in zip(a.plane_lens, a.groups))
        assert 0 < a.ica_query_capacity < slots
    w = refmod.make_weights(a, 11, "cpu")
    model = build_model(a, w, "cpu")
    ref = refmod.Ref(a, w)
    w2p = torch.from_numpy(rig(a))
    with torch.no_grad():
        for seed in (1, 2):
            feats = _feats(a, seed)
            got, want = model(feats, w2p), ref.forward(feats, w2p)
            assert int(got["ica_overflow"]) == 0
            assert got["logits"].shape == (1, 18, 8, 8, 4)
            for key in KEYS:
                torch.testing.assert_close(got[key], want[key], rtol=1e-4,
                                           atol=5e-5, msg=key)


def test_a_capacity_too_small_reports_overflow():
    a = _arch()
    a = _arch(ica_query_capacity=_capacity(a) - 3)
    model = build_model(a, refmod.make_weights(a, 2, "cpu"), "cpu")
    with torch.no_grad():
        out = model(_feats(a, 3), torch.from_numpy(rig(a)))
    assert int(out["ica_overflow"]) == 3


def test_grouped_side_planes_equal_a_direct_per_anchor_form():
    """The image cross-attention's side planes cut into groups of 4
    anchors with 8 points a level, the groups' outputs summed, against
    one attention of every point at its own anchor."""
    a = _arch()
    model = build_model(a, refmod.make_weights(a, 5, "cpu"), "cpu")
    cfg = model.cfg
    ica = model.tpv_head.encoder.layers[0].attentions[1]
    g = torch.Generator().manual_seed(4)
    n = sum(cfg.plane_lens)
    query = torch.randn((1, n, cfg.embed_dims), generator=g)
    value = torch.randn((1, cfg.num_cams, sum(h * w for h, w in
                                              cfg.feat_shapes),
                         cfg.embed_dims), generator=g)
    w2p = torch.from_numpy(rig(a))
    lift = model.tpv_head.encoder.lift(w2p)
    with torch.no_grad():
        got = ica(query, value, lift)
        # direct form
        da = ica.deformable_attention
        heads, L = cfg.num_heads, cfg.num_levels
        d = cfg.embed_dims // heads
        v = da.value_proj(value).reshape(cfg.num_cams, -1, heads, d)
        norm = torch.tensor([[w, h] for h, w in cfg.feat_shapes])
        outs = []
        for i, (q, pts) in enumerate(zip(query.split(cfg.plane_lens, 1),
                                         tpv.pillar_points(cfg))):
            m, A, P = q.shape[1], cfg.num_points_in_pillar[i], \
                cfg.num_points[i]
            a0, per = cfg.num_points_in_pillar[0], cfg.num_points[0]
            off = da.sampling_offsets[i](q)[0].reshape(m, heads, L, P, 2)
            att = da.attention_weights[i](q)[0].reshape(
                m, heads, L * P).softmax(-1).reshape(m, heads, L, P)
            # point k of a level: group k // per, anchor within the group
            # k % a0 (anchors inner, as upstream's view)
            anchor = torch.tensor([(k // per) * a0 + k % a0
                                   for k in range(P)])
            xy, mask = geometry.project_reference_points(
                pts.reshape(-1, 3), w2p, torch.zeros((1, 3)),
                pc_range=cfg.pc_range, image_wh=cfg.image_wh)
            xy = xy.reshape(cfg.num_cams, m, A, 2)
            seen = mask.reshape(cfg.num_cams, m, A).any(-1)
            total = torch.zeros((m, cfg.embed_dims))
            for c in range(cfg.num_cams):
                loc = xy[c][:, None, None, anchor, :] \
                    + off / norm[None, None, :, None, :]
                out = ms_deform_attn_2d(v[c:c + 1], cfg.feat_shapes,
                                        loc[None], att[None])[0]
                total += out * seen[c][:, None]
            outs.append(total / seen.sum(0).clamp(min=1)[:, None])
        want = ica.output_proj(torch.cat(outs)[None]) + query
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_hybrid_weights_factor_and_sum_to_one():
    g = torch.Generator().manual_seed(6)
    logits = torch.randn((5, 7, 8, 3, 33), generator=g) * 3.0
    w = tpv.hybrid_weights(logits)
    assert w.shape == (5, 7, 8, 3, 32)
    torch.testing.assert_close(w.sum((-1, -2)), torch.ones((5, 7, 8)))
    level = logits[..., 32].softmax(-1)
    torch.testing.assert_close(w.sum(-1), level)


def test_cross_view_reference_points_are_upstreams():
    cfg = tpv.TPVConfig(tpv_h=6, tpv_w=5, tpv_z=3, hybrid_anchors=4)
    got = tpv.cross_view_ref_points(cfg)
    want = refmod.get_cross_view_ref_points(6, 5, 3, 4, "cpu")
    torch.testing.assert_close(got, want)


def test_configuration_keeps_the_published_widths():
    a = refmod.Arch(SPEC)
    assert (a.embed_dims, a.num_heads, a.head_dim, a.ffn_dim) == \
        (128, 8, 16, 256)
    assert a.plane_shapes == ((100, 100), (8, 100), (100, 8))
    assert a.level_shapes == ((116, 200), (58, 100), (29, 50), (15, 25))
    assert a.value_rows == 30825 and a.queries == 11600
    assert (a.num_points_in_pillar, a.num_points) == ((4, 32, 32),
                                                      (8, 64, 64))
    assert (a.hybrid_anchors, a.hybrid_points) == (16, 32)
    assert a.lattice == (200, 200, 16) and a.num_classes == 18
    assert (a.encoder_layers, a.cross_layers, a.pos_dims) == \
        (5, 3, (48, 48, 32))
    assert a.dtype == "float32" and a.ln_eps == 1e-5


def test_capacity_is_the_rigs_rounded_up_and_counts_what_the_lift_sees():
    a = refmod.Arch(SPEC)
    cfg = tpv.TPVConfig(ica_query_capacity=a.ica_query_capacity)
    need = tpv.max_visible_slots(rig(a), cfg)
    assert a.ica_query_capacity == -(-need // 64) * 64
    enc = tpv.TPVFormerEncoder(tpv.TPVConfig())
    lift = enc.lift(torch.from_numpy(rig(a)))
    seen = lift.valid.sum(-1)
    assert int(seen.max()) <= need <= int(seen.max()) + 8


# TPVFormer's samplings: the lift over 6 cameras' 4 levels at the cell's
# capacity, 8 points a level; the hybrid attention over the 3 planes, 32
# points a level
ICA = ("TPVFormer ICA", 6, ((116, 200), (58, 100), (29, 50), (15, 25)),
       16, 12544, 8)
CVHA = ("TPVFormer CVHA", 1, ((100, 100), (8, 100), (100, 8)), 16, 11600,
        32)
BASE_SCA = ("BEVFormer-base SCA", 6,
            ((116, 200), (58, 100), (29, 50), (15, 25)), 32, 12608, 8)


@pytest.mark.parametrize("elt, lanes", [(4, 16), (2, 8)])
@pytest.mark.parametrize("case", [ICA, CVHA], ids=["ica", "cvha"])
def test_tpvformer_shapes_take_the_narrow_gather_layout(case, elt, lanes):
    _, bs, shapes, d, nq, _ = case
    assert deform_cuda.route(shapes, d, elt) == deform_cuda.GATHER_ROUTE
    plan = deform_cuda.plan_gather(bs, 8, nq, len(shapes), d, elt, 132)
    assert plan.point_lanes == lanes
    assert plan.items == bs * nq * 8
    wide = deform_cuda.plan_gather(6, 8, 12608, 4, 32, elt, 132)
    assert wide.point_lanes == 32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [ICA, CVHA, BASE_SCA],
                         ids=["ica", "cvha", "bevformer-sca"])
def test_gather_kernel_matches_the_plain_version(case, dtype):
    """On the card: the gather kernel at the full shapes against the plain
    version, relative L2 within 1e-5 in fp32 (bf16: the values rounded
    once, both sides reading the same bf16 values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, bs, shapes, d, nq, P = case
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    rows, L, heads = sum(h * w for h, w in shapes), len(shapes), 8
    value = torch.from_numpy(rng.standard_normal(
        (bs, rows, heads, d)).astype(np.float32)).to(dev, dt)
    loc = torch.from_numpy(rng.uniform(
        -0.1, 1.1, (bs, nq, heads, L, P, 2)).astype(np.float32)).to(dev)
    wgt = torch.from_numpy(rng.standard_normal(
        (bs, nq, heads, L * P)).astype(np.float32)).to(dev).softmax(
            -1).reshape(bs, nq, heads, L, P).contiguous()
    before = deform_cuda.GATHER.launches
    with torch.inference_mode():
        got = deform_cuda.ms_deform_attn_2d_fused(value, shapes, loc, wgt)
        want = ms_deform_attn_2d(value.float(), shapes, loc, wgt)
    assert deform_cuda.GATHER.launches == before + 1
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= (1e-5 if dtype == "float32" else 1e-2), rel
