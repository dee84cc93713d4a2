"""The port's encoder path against the JAX package, fp32 on the CPU, with
weights carried by ``state_dict_from_jax``: SpatialCrossAttention,
VoxelEncoderLayer and the whole ``VoxelFormer(only_bev=True)`` slice.
bev_embed tolerance rtol 1e-4 / atol 2e-5 (the JAX package's own bound
against its torch oracle, tests/test_convert_voxelformer.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_ver_tpu import geometry as jgeo
from vln_ver_tpu.config import build_ver_config as jax_build_ver_config
from vln_ver_tpu.config import load_config as jax_load_config
from vln_ver_tpu.models import VERConfig as JaxVERConfig
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.models.attention import (
    SpatialCrossAttention as JaxSpatialCrossAttention)
from vln_ver_tpu.models.encoder import VoxelEncoderLayer as JaxEncoderLayer
from vln_ver_tpu_torch.config import build_ver_config, load_config
from vln_ver_tpu_torch.convert import state_dict_from_jax
from vln_ver_tpu_torch.models import VERConfig, VoxelFormer
from vln_ver_tpu_torch.runtime import resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny config of tests/test_convert_voxelformer.py
JCFG = JaxVERConfig(
    num_cams=3, feat_h=6, feat_w=6, in_channels=64,
    embed_dims=64, num_heads=4, encoder_layers=2, decoder_layers=2,
    ffn_dim=128, num_query=12, num_layout_query=4, num_classes=5,
    occupancy_classes=4, occ_dims=8,
    bev_z=2, bev_h=5, bev_w=5,
    occupancy_size=(0.6, 0.6, 0.5),
    dropout_rate=0.0, deform_impl="gather",
    refine_occ=True, occ_layout="ref",
)
TCFG = VERConfig(**{f.name: getattr(JCFG, f.name)
                    for f in dataclasses.fields(VERConfig)
                    if f.name != "dtype"})


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


def _perturb(tree, rng):
    """Move every leaf off its flax init (zero offset and attention
    kernels would leave the learned sampling untested)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    feats, w2p, shift = _inputs(1)
    params = JaxVoxelFormer(JCFG).init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(w2p),
        jnp.asarray(shift))["params"]
    params = _perturb(params, np.random.default_rng(1))
    sd, not_ported = state_dict_from_jax(params, TCFG)
    model = VoxelFormer(TCFG)
    model.load_state_dict(sd, strict=True)
    return params, model.eval(), not_ported


def test_state_dict_from_jax_maps_the_whole_encoder_path(weights):
    params, model, not_ported = weights
    assert set(model.state_dict()) == set(
        state_dict_from_jax(params, TCFG)[0])
    # the full model is ported: no leaf of the JAX tree is left over
    assert not not_ported
    k = ("pts_bbox_head.transformer.encoder.layers.0.attentions.0."
         "deformable_attention.value_proj.weight")
    np.testing.assert_array_equal(
        model.state_dict()[k].numpy(),
        params["pts_bbox_head"]["transformer"]["encoder"]["layer_0"][
            "cross_attn"]["deformable_attention"]["value_proj"]["kernel"].T)


def _sca_inputs(seed, hw, b=2, nq=50, cams=3, c=64):
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((b, nq, c)).astype(np.float32)
    value = rng.standard_normal((b, cams, hw[0] * hw[1], c)).astype(
        np.float32)
    ref = rng.uniform(-0.2, 1.2, (b, cams, nq, 1, 2)).astype(np.float32)
    mask = rng.random((b, cams, nq, 1)) < 0.4
    mask[0, :, :5] = False      # queries no camera sees: count clamps to 1
    return query, value, ref, mask


def test_spatial_cross_attention_matches_jax(weights):
    params, model, _ = weights
    jp = params["pts_bbox_head"]["transformer"]["encoder"]["layer_1"][
        "cross_attn"]
    # a non-square map: the offset normaliser is [w, h], not [h, w]
    args = _sca_inputs(seed=2, hw=(4, 9))
    ref = JaxSpatialCrossAttention(
        embed_dims=64, num_heads=4, num_points=JCFG.sca_num_points,
        dropout_rate=0.0, deform_impl="gather").apply(
            {"params": jp}, *map(jnp.asarray, args), ((4, 9),))
    sca = model.pts_bbox_head.transformer.encoder.layers[1].attentions[0]
    with torch.inference_mode():
        got = sca(*map(torch.from_numpy, args), ((4, 9),))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-5)


def test_encoder_layer_matches_jax(weights):
    params, model, _ = weights
    jp = params["pts_bbox_head"]["transformer"]["encoder"]["layer_0"]
    args = _sca_inputs(seed=3, hw=(9, 4))
    ref = JaxEncoderLayer(JCFG).apply({"params": jp},
                                      *map(jnp.asarray, args), ((9, 4),))
    layer = model.pts_bbox_head.transformer.encoder.layers[0]
    with torch.inference_mode():
        got = layer(*map(torch.from_numpy, args), ((9, 4),))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-5)


def test_layernorm_matches_flax():
    """flax LayerNorm's eps is 1e-6 (torch's default 1e-5): on inputs of
    small variance the two defaults differ by percents."""
    import flax.linen as fnn
    from vln_ver_tpu_torch.models.layers import LayerNorm
    x = 0.01 * np.random.default_rng(5).standard_normal(
        (3, 7, 64)).astype(np.float32)
    ref = fnn.LayerNorm().apply(
        {"params": {"scale": np.ones(64, np.float32),
                    "bias": np.zeros(64, np.float32)}}, jnp.asarray(x))
    with torch.inference_mode():
        got = LayerNorm(64)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("batch,seed", [(1, 0), (2, 4)])
def test_voxelformer_only_bev_matches_jax(weights, batch, seed):
    params, model, _ = weights
    feats, w2p, shift = _inputs(batch, seed)
    ref = JaxVoxelFormer(JCFG).apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(w2p),
        jnp.asarray(shift), only_bev=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(w2p),
                    torch.from_numpy(shift), only_bev=True)
    assert got["sca_overflow"] == int(ref["sca_overflow"]) == 0
    np.testing.assert_allclose(got["bev_embed"].numpy(),
                               np.asarray(ref["bev_embed"]), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("name", ["get_occ.py", "vocc_tiny.py", "vocc.py"])
def test_config_loader_matches_jax(name):
    path = os.path.join(REPO, "configs", "verformer", name)
    t = build_ver_config(load_config(path))
    j = jax_build_ver_config(jax_load_config(path))
    for f in dataclasses.fields(VERConfig):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.float32


def test_compute_dtype_option_maps_to_torch_bfloat16():
    from vln_ver_tpu_torch.config import apply_cfg_options
    cfg = apply_cfg_options(load_config(os.path.join(
        REPO, "configs/verformer/vocc_tiny.py")), ["compute_dtype=bfloat16"])
    assert build_ver_config(cfg).dtype == torch.bfloat16


def test_capacity_lift_builds_and_runs(weights):
    """``sca_query_capacity`` builds the same parameter tree as the dense
    lift, and with a capacity that covers every camera (its geometry's
    ``max_visible_queries``) its forward is the dense one's, with a zero
    overflow on the device; one below it reports the drop."""
    from vln_ver_tpu_torch.geometry import max_visible_queries
    _, dense, _ = weights
    feats, w2p, shift = _inputs(2, seed=6)
    need = max_visible_queries(w2p, shift, TCFG.bev_z, TCFG.bev_h,
                               TCFG.bev_w, TCFG.pc_range)
    assert 0 < need < TCFG.bev_num
    x = [torch.from_numpy(a) for a in (feats, w2p, shift)]
    with torch.inference_mode():
        ref = dense(*x)
        for cap, overflow in ((need, 0), (need // 2, None)):
            model = VoxelFormer(dataclasses.replace(
                TCFG, sca_query_capacity=cap)).eval()
            model.load_state_dict(dense.state_dict(), strict=True)
            got = model(*x)
            assert isinstance(got["sca_overflow"], torch.Tensor)
            if overflow is None:
                assert int(got["sca_overflow"]) > 0
                continue
            assert int(got["sca_overflow"]) == 0
            for k in ("bev_embed", "all_cls_scores", "occupancy_preds"):
                np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                           rtol=2e-5, atol=2e-5, err_msg=k)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_fp32_forward_runs_without_tf32(weights, monkeypatch):
    """An fp32 model's forward runs its matmuls and its upsampler's
    convolutions in true fp32 whatever the caller left in the process-wide
    TF32 flags (cuDNN's defaults to True), and puts the flags back."""
    _, model, _ = weights
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    hook = model.pts_bbox_head.up_sample.register_forward_pre_hook(
        lambda mod, args: seen.append((torch.backends.cuda.matmul.allow_tf32,
                                       torch.backends.cudnn.allow_tf32)))
    try:
        with torch.inference_mode():
            model(*map(torch.from_numpy, _inputs(1)))
    finally:
        hook.remove()
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
