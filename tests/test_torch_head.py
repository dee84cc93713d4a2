"""The port's head and full forward against the JAX package, fp32 on the
CPU: the class, regression and layout branches, the upsampler, every mode
x ``occ_layout`` x ``refine_occ`` of ``VoxelFormer`` (``only_bev=False``)
and the reference layout against the torch oracle of the reference
(tests/oracle_voxelformer.py); plus the weight converter and the strict
checkpoint loader.  Tolerances: rtol 1e-4 with atol 2e-5 on ``bev_embed``
and 5e-5 on the head outputs, the JAX package's own against its oracle
(tests/test_convert_voxelformer.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import JCFG, TCFG, jax_params, port_model

from oracle_voxelformer import OracleVoxelFormer
from vln_ver_tpu import geometry as jgeo
from vln_ver_tpu.convert import export_state_dict
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.models.head import ClsBranch as JaxClsBranch
from vln_ver_tpu.models.head import LayoutBranch as JaxLayoutBranch
from vln_ver_tpu.models.head import OccBranch as JaxOccBranch
from vln_ver_tpu.models.head import OccUpsampler as JaxOccUpsampler
from vln_ver_tpu.models.transformer import RegBranch as JaxRegBranch
from vln_ver_tpu_torch.convert import load_checkpoint, state_dict_from_jax
from vln_ver_tpu_torch.models import VoxelFormer, build_model

torch.set_num_threads(1)

OUTPUTS = ("bev_embed", "all_cls_scores", "all_bbox_preds",
           "all_layout_preds", "occupancy_preds")


def _cfgs(**kw):
    return (dataclasses.replace(JCFG, **kw),
            dataclasses.replace(TCFG, **kw))


# one JAX tree with every leaf any mode below reads
JFULL, TFULL = _cfgs(occ_layout="zhwc", add_layout=True)
# bev_z == occ_zdim: occ_proj projects each voxel, no z fusing
EQUAL_Z = dict(occupancy_size=(0.6, 0.6, 1.75))


@pytest.fixture(scope="module")
def params():
    return jax_params(JFULL, seed=3)


@pytest.fixture(scope="module")
def params_equal_z():
    return jax_params(dataclasses.replace(JFULL, **EQUAL_Z), seed=3)


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (batch, JCFG.num_cams, JCFG.feat_h, JCFG.feat_w,
         JCFG.in_channels)).astype(np.float32)
    w2p = np.stack([np.stack([
        jgeo.make_pinhole_world2pixel(90.0, deg, [0.1 * b, -0.1, 1.0])
        for deg in (0.0, 120.0, 240.0)]) for b in range(batch)])
    shift = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    return feats, w2p.astype(np.float32), shift


def _check(got, ref):
    for k in OUTPUTS:
        if ref[k] is None:
            assert got[k] is None, k
            continue
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
            atol=2e-5 if k == "bev_embed" else 5e-5, err_msg=k)
    assert got["flow_preds"] is None and got["sca_overflow"] == 0


def test_branches_match_jax(params):
    model = port_model(params, TFULL)
    head = model.pts_bbox_head
    hp = params["pts_bbox_head"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    xo = rng.standard_normal((2, 7, JCFG.occ_dims)).astype(np.float32)
    cases = [
        (JaxClsBranch(64, 5), hp["cls_branch_1"], head.cls_branches[1], x),
        (JaxRegBranch(64, 10), hp["transformer"]["reg_branch_0"],
         head.reg_branches[0], x),
        (JaxLayoutBranch(64, 10), hp["layout_branch_1"],
         head.layout_branches[1], x),
        (JaxOccBranch(JCFG.occ_dims, 4), hp["occ_branches"],
         head.occ_branches, xo)]
    for jmod, p, tmod, inp in cases:
        ref = jmod.apply({"params": p}, jnp.asarray(inp))
        with torch.inference_mode():
            got = tmod(torch.from_numpy(inp))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=5e-5)


def test_upsampler_matches_jax(params):
    """The model's upsampler, the port of JAX's even-grid factorisation
    (``OccUpsampler``), against JAX's on the converted weights: the full
    output, NDHWC, at the tiny config's width and bev_z = 2
    (tests/test_torch_upsampler.py holds z = 3 and 4 and each method)."""
    model = port_model(params, TFULL)
    x = np.random.default_rng(2).standard_normal(
        (2, JCFG.bev_z, JCFG.bev_h, JCFG.bev_w, 64)).astype(np.float32)
    up = params["pts_bbox_head"]["up_sample"]
    ref = JaxOccUpsampler(64, num_stages=len(up)).apply(
        {"params": up}, jnp.asarray(x))
    with torch.inference_mode():
        got = model.pts_bbox_head.up_sample(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape == (2, 2, 20, 20, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=5e-5)
    # every odd row and column is the last stage's bias alone
    bias = model.pts_bbox_head.up_sample[-1].bias.detach().numpy()
    np.testing.assert_allclose(got.numpy()[:, :, 1::2], np.broadcast_to(
        bias, got[:, :, 1::2].shape), atol=1e-6)


MODES = {"default": {}, "only_occ": dict(only_occ=True),
         "only_det": dict(only_det=True, add_layout=True),
         "add_layout": dict(add_layout=True)}
HEADS = {"zhwc": dict(occ_layout="zhwc"),
         "zhwc_dense": dict(occ_layout="zhwc_dense"),
         "ref": dict(occ_layout="ref"),
         "no_refine": dict(refine_occ=False),
         "zhwc_equal_z": dict(occ_layout="zhwc", **EQUAL_Z),
         "ref_equal_z": dict(occ_layout="ref", **EQUAL_Z)}
CASES = [(m, h) for m in MODES for h in HEADS
         if m != "only_det" or h == "zhwc"]   # only_det has no occupancy


@pytest.mark.parametrize("mode,head", CASES)
def test_full_forward_matches_jax(params, params_equal_z, mode, head):
    jcfg, tcfg = _cfgs(**MODES[mode], **HEADS[head])
    if head.endswith("equal_z"):
        params = params_equal_z
    feats, w2p, shift = _inputs(2, seed=len(mode) + len(head))
    ref = JaxVoxelFormer(jcfg).apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(w2p),
        jnp.asarray(shift))
    model = port_model(params, tcfg)
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(w2p),
                    torch.from_numpy(shift))
    assert list(got) == list(ref)
    _check(got, ref)


def test_occ_layouts_agree_and_ref_differs(params):
    """'zhwc' (even cells plus one bias cell) is the function of
    'zhwc_dense'; 'ref' scrambles the voxel/channel axes."""
    feats, w2p, shift = map(torch.from_numpy, _inputs(1, seed=9))
    outs = {}
    for layout in ("zhwc", "zhwc_dense", "ref"):
        model = port_model(params, dataclasses.replace(TFULL,
                                                       occ_layout=layout))
        with torch.inference_mode():
            outs[layout] = model(feats, w2p, shift)["occupancy_preds"]
    torch.testing.assert_close(outs["zhwc"], outs["zhwc_dense"], rtol=1e-5,
                               atol=1e-5)
    assert not torch.allclose(outs["zhwc"], outs["ref"], atol=1e-2)


@pytest.fixture(scope="module")
def oracle():
    torch.manual_seed(0)
    oracle = OracleVoxelFormer(JCFG)
    with torch.no_grad():
        for p in oracle.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    return oracle


def test_ref_layout_matches_reference_oracle(oracle, tmp_path):
    """The reference's own module tree, state_dict and forward: its .pth
    loads into the port by name (``load_checkpoint``, the always-built
    layout branches ignored) and the port's 'ref' layout reproduces every
    output."""
    pth = str(tmp_path / "reference.pth")
    torch.save({"state_dict": oracle.state_dict(), "meta": {}}, pth)
    model = VoxelFormer(TCFG)
    ignored = load_checkpoint(model, pth)
    assert ignored and all(k.startswith("pts_bbox_head.layout_branches.")
                           for k in ignored)
    feats, w2p, shift = _inputs(1, seed=4)
    ref = oracle(torch.from_numpy(feats[0].reshape(
        JCFG.num_cams, 1, JCFG.feat_h * JCFG.feat_w, JCFG.in_channels)),
        torch.from_numpy(w2p), torch.from_numpy(shift))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(w2p),
                           torch.from_numpy(shift))
    torch.testing.assert_close(got["bev_embed"],
                               ref["bev_embed"].transpose(0, 1), rtol=1e-4,
                               atol=2e-5)
    for k in ("all_cls_scores", "all_bbox_preds", "occupancy_preds"):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("kw", [{}, dict(add_layout=True),
                                dict(only_occ=True), dict(only_det=True),
                                dict(refine_occ=False), EQUAL_Z])
def test_state_dict_from_jax_maps_every_leaf(params, kw):
    """A JAX tree initialised for the config maps onto every parameter of
    the port's model, and no leaf is left over."""
    jcfg, tcfg = _cfgs(**kw)
    tree = jax_params(jcfg, seed=5)
    sd, unmapped = state_dict_from_jax({"params": tree}, tcfg)
    assert unmapped == []
    model = VoxelFormer(tcfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)


def test_state_dict_from_jax_refuses_a_missing_leaf(params):
    tree = jax.tree_util.tree_map(np.asarray, params)
    del tree["pts_bbox_head"]["transformer"]["decoder"]["layer_1"]["norm3"]
    with pytest.raises(KeyError, match="norm3"):
        state_dict_from_jax(tree, TFULL)


def test_converter_transforms(params):
    """MHA q/k/v packing and the flipped, transposed upsampler kernel,
    checked against the JAX package's export to reference names."""
    sd, _ = state_dict_from_jax(params, TFULL)
    ref = export_state_dict(params, JFULL)
    keys = [k for k in ref if "in_proj" in k or "up_sample" in k
            or "out_proj" in k]
    assert len(keys) >= 4 * JCFG.decoder_layers + 4
    for k in keys:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)


def test_load_checkpoint_is_strict(params, tmp_path):
    sd = {k: torch.from_numpy(v)
          for k, v in export_state_dict(params, JFULL).items()}
    model = VoxelFormer(TFULL)
    pth = str(tmp_path / "full.pth")
    torch.save({"state_dict": sd, "meta": {}}, pth)
    assert load_checkpoint(model, pth) == []
    want, _ = state_dict_from_jax(params, TFULL)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)

    missing = dict(sd)
    del missing["pts_bbox_head.up_sample.1.bias"]
    torch.save(missing, pth)
    with pytest.raises(KeyError, match="lacks parameters"):
        load_checkpoint(VoxelFormer(TFULL), pth)
    torch.save(dict(sd, **{"pts_bbox_head.stray.weight": torch.zeros(1)}),
               pth)
    with pytest.raises(KeyError, match="no parameter"):
        load_checkpoint(VoxelFormer(TFULL), pth)
    # the reference's dead image backbone is ignored and reported
    torch.save(dict(sd, **{"img_backbone.conv1.weight": torch.zeros(1)}),
               pth)
    assert load_checkpoint(VoxelFormer(TFULL), pth) == [
        "img_backbone.conv1.weight"]


def test_init_weights_follows_the_flax_initialisers():
    model = build_model(TFULL, "cpu", seed=0)
    head = model.pts_bbox_head
    c = TFULL.embed_dims
    w = head.up_sample[0].weight.detach()
    std = np.sqrt(1.0 / (75 * c))
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 * std / .87962566103423978 + 1e-6
    assert abs(float(head.query_embedding.weight.detach().std()) - 1.0) < 0.05
    xattn = head.transformer.decoder.layers[0].attentions[1]
    assert not xattn.sampling_offsets.weight.any()
    assert not xattn.attention_weights.weight.any()
    assert xattn.sampling_offsets.bias.abs().max() > 0
    prior = -np.log((1 - 0.01) / 0.01)
    np.testing.assert_allclose(head.cls_branches[0][-1].bias.detach(), prior,
                               rtol=1e-6)
    np.testing.assert_allclose(head.occ_branches[-1].bias.detach(), prior,
                               rtol=1e-6)
    assert not head.reg_branches[0][-1].bias.any()
    mha = head.transformer.decoder.layers[0].attentions[0].attn
    std = float(mha.in_proj_weight.detach().std())
    assert abs(std * np.sqrt(c) - 1.0) < 0.05


@pytest.mark.parametrize("kw,match", [
    (dict(occupancy_size=(0.5, 0.5, 0.5)), "refine_occ"),
    (dict(occ_layout="xyz"), "occ_layout")])
def test_unported_or_invalid_heads_are_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        VoxelFormer(dataclasses.replace(TCFG, **kw))
