"""The port's decoder path against the JAX package, fp32 on the CPU:
trilinear sampling, 3D deformable attention (against JAX's gather and
one-hot forms), VoxelDeformableAttention3D, MultiheadAttention and the
decoder stack with its box refinement.  Weights come from one JAX
VoxelFormer through ``state_dict_from_jax``.  Tolerance rtol 1e-4 /
atol 5e-5, the JAX package's head bound against its torch oracle
(tests/test_convert_voxelformer.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_ver_tpu.models import VERConfig as JaxVERConfig
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.models.attention import (
    MultiheadAttention as JaxMultiheadAttention)
from vln_ver_tpu.models.attention import (
    VoxelDeformableAttention3D as JaxVoxelDeformableAttention3D)
from vln_ver_tpu.models.attention import _offset_grid_init_3d as jax_grid3d
from vln_ver_tpu.models.decoder import DecoderLayer as JaxDecoderLayer
from vln_ver_tpu.models.decoder import (
    VoxelDetectionDecoder as JaxVoxelDetectionDecoder)
from vln_ver_tpu.models.decoder import inverse_sigmoid as jax_inverse_sigmoid
from vln_ver_tpu.models.transformer import RegBranch as JaxRegBranch
from vln_ver_tpu.ops import deform_attn as jax_deform
from vln_ver_tpu.ops.sampling import trilinear_sample_3d as jax_trilinear
from vln_ver_tpu_torch.convert import state_dict_from_jax
from vln_ver_tpu_torch.models import VERConfig, VoxelFormer
from vln_ver_tpu_torch.models.attention import _offset_grid_init_3d
from vln_ver_tpu_torch.models.decoder import inverse_sigmoid
from vln_ver_tpu_torch.ops.deform_attn import voxel_deform_attn_3d
from vln_ver_tpu_torch.ops.sampling import trilinear_sample_3d

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 5e-5

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


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(ref), rtol=RTOL, atol=atol)


def jax_params(cfg, seed: int = 0):
    """Random parameters of a JAX VoxelFormer for ``cfg``, from a numpy
    seed at flax-init-like scales (kernels 1/sqrt(fan-in), LayerNorm
    scales near 1, small biases, unit tables).  Only their shapes come from
    flax (``jax.eval_shape``: the init is traced, not run)."""
    x = (jnp.zeros((1, cfg.num_cams, cfg.feat_h, cfg.feat_w,
                    cfg.in_channels)),
         jnp.tile(jnp.eye(4), (1, cfg.num_cams, 1, 1)), jnp.zeros((1, 3)))
    shapes = jax.eval_shape(JaxVoxelFormer(cfg).init,
                            jax.random.PRNGKey(0), *x)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        a = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * a
        if name == "bias":
            return 0.1 * a
        return a

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(params, cfg):
    """The port's VoxelFormer for ``cfg`` carrying ``params``."""
    sd, _ = state_dict_from_jax(params, cfg)
    model = VoxelFormer(cfg)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def weights():
    params = jax_params(JCFG)
    return params, port_model(params, TCFG)


def _sample_inputs(seed, shape, s=40, lo=-0.3, hi=1.3):
    rng = np.random.default_rng(seed)
    b, d, h, w, c = shape
    value = rng.standard_normal(shape).astype(np.float32)
    coords = [rng.uniform(lo, hi, (b, s)).astype(np.float32) * n - 0.5
              for n in (w, h, d)]
    return value, coords


def test_trilinear_sample_matches_jax():
    value, (x, y, z) = _sample_inputs(0, (2, 3, 4, 5, 6))
    ref = jax_trilinear(jnp.asarray(value), *map(jnp.asarray, (x, y, z)))
    got = trilinear_sample_3d(*map(torch.from_numpy, (value, x, y, z)))
    _close(got, ref, atol=1e-6)


def test_trilinear_far_out_taps_are_zero():
    """Learned offsets can put a location anywhere: a tap bound tested
    after an int conversion would wrap 1e10 into range."""
    value = torch.ones(1, 3, 4, 5, 2)
    far = torch.tensor([[1e10, -1e10, 1.0, 4.0, -1.0]])
    mid = torch.full_like(far, 1.0)
    for x, y, z in ((far, mid, mid), (mid, far, mid), (mid, mid, far)):
        out = trilinear_sample_3d(value, x, y, z)
        assert torch.equal(out[0, :2], torch.zeros(2, 2))
    # in range every weight sums to one; half a tap out, to one half
    out = trilinear_sample_3d(value, mid, mid, mid)
    torch.testing.assert_close(out, torch.ones_like(out))
    out = trilinear_sample_3d(value, torch.tensor([[-0.5]]),
                              torch.tensor([[1.0]]), torch.tensor([[1.0]]))
    torch.testing.assert_close(out, torch.full_like(out, 0.5))


@pytest.mark.parametrize("form", ["gather", "onehot"])
@pytest.mark.parametrize("depth", [1, 3])
def test_voxel_deform_attn_3d_matches_jax(form, depth):
    rng = np.random.default_rng(depth)
    bs, heads, hd, nq, pts = 2, 4, 8, 11, 4
    shapes = ((depth, 5, 6),)
    value = rng.standard_normal(
        (bs, depth * 30, heads, hd)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (bs, nq, heads, 1, pts, 3)).astype(
        np.float32)
    logits = rng.standard_normal((bs, nq, heads, 1, pts))
    attn = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    fn = (jax_deform.voxel_deform_attn_3d if form == "gather"
          else jax_deform.voxel_deform_attn_3d_onehot)
    ref = fn(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = voxel_deform_attn_3d(*map(torch.from_numpy, (value,)), shapes,
                               torch.from_numpy(loc), torch.from_numpy(attn))
    _close(got, ref, atol=2e-6)


def test_offset_grid_init_3d_matches_jax():
    np.testing.assert_allclose(_offset_grid_init_3d(8, 1, 4).numpy(),
                               np.asarray(jax_grid3d(8, 1, 4)), atol=1e-7)


def test_inverse_sigmoid_matches_jax():
    x = np.array([-0.5, 0.0, 1e-7, 1e-5, 0.3, 0.5, 1 - 1e-6, 1.0, 2.0],
                 np.float32)
    _close(inverse_sigmoid(torch.from_numpy(x)),
           jax_inverse_sigmoid(jnp.asarray(x)), atol=1e-6)


def _decoder_inputs(seed, nv=50, nq=12, b=2, c=64):
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((b, nq, c)).astype(np.float32)
    value = rng.standard_normal((b, nv, c)).astype(np.float32)
    pos = rng.standard_normal((b, nq, c)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, (b, nq, 3)).astype(np.float32)
    return query, value, pos, ref


@pytest.mark.parametrize("shape", [(2, 5, 5), (1, 5, 10)])
def test_voxel_deformable_attention_matches_jax(weights, shape):
    params, model = weights
    jp = params["pts_bbox_head"]["transformer"]["decoder"]["layer_1"][
        "cross_attn"]
    q, v, pos, ref = _decoder_inputs(2, nv=int(np.prod(shape)))
    args = (q, v, ref[:, :, None, :])
    out = JaxVoxelDeformableAttention3D(
        embed_dims=64, num_heads=4, num_points=4, dropout_rate=0.0,
        deform_impl="gather").apply(
            {"params": jp}, *map(jnp.asarray, args), (shape,),
            query_pos=jnp.asarray(pos))
    attn = model.pts_bbox_head.transformer.decoder.layers[1].attentions[1]
    with torch.inference_mode():
        got = attn(*map(torch.from_numpy, args), (shape,),
                   query_pos=torch.from_numpy(pos))
    _close(got, out)


@pytest.mark.parametrize("with_pos", [False, True])
def test_multihead_attention_matches_jax(weights, with_pos):
    params, model = weights
    jp = params["pts_bbox_head"]["transformer"]["decoder"]["layer_0"][
        "self_attn"]
    q, _, pos, _ = _decoder_inputs(3)
    kw = {"query_pos": pos} if with_pos else {}
    ref = JaxMultiheadAttention(embed_dims=64, num_heads=4,
                                dropout_rate=0.0).apply(
        {"params": jp}, jnp.asarray(q),
        **{k: jnp.asarray(a) for k, a in kw.items()})
    mha = model.pts_bbox_head.transformer.decoder.layers[0].attentions[0]
    with torch.inference_mode():
        got = mha(torch.from_numpy(q),
                  **{k: torch.from_numpy(a) for k, a in kw.items()})
    _close(got, ref)


def test_decoder_layer_matches_jax(weights):
    params, model = weights
    jp = params["pts_bbox_head"]["transformer"]["decoder"]["layer_0"]
    q, v, pos, ref = _decoder_inputs(4)
    shapes = ((2, 5, 5),)
    out = JaxDecoderLayer(JCFG).apply(
        {"params": jp}, jnp.asarray(q), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(ref[:, :, None, :]), shapes)
    layer = model.pts_bbox_head.transformer.decoder.layers[0]
    with torch.inference_mode():
        got = layer(torch.from_numpy(q), torch.from_numpy(v),
                    torch.from_numpy(pos),
                    torch.from_numpy(ref[:, :, None, :]), shapes)
    _close(got, out)


def test_decoder_stack_with_refinement_matches_jax(weights):
    params, model = weights
    tp = params["pts_bbox_head"]["transformer"]
    q, v, pos, ref = _decoder_inputs(5)
    shapes = ((2, 5, 5),)
    reg_fns = [
        (lambda x, p=tp[f"reg_branch_{i}"]: JaxRegBranch(64, 10).apply(
            {"params": p}, x)) for i in range(JCFG.decoder_layers)]
    states, refs, raws = JaxVoxelDetectionDecoder(JCFG).apply(
        {"params": tp["decoder"]}, jnp.asarray(q), jnp.asarray(v),
        jnp.asarray(pos), jnp.asarray(ref), reg_fns, shapes)
    head = model.pts_bbox_head
    with torch.inference_mode():
        got = head.transformer.decoder(
            torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(pos),
            torch.from_numpy(ref), head.reg_branches, shapes)
    for g, r in zip(got, (states, refs, raws)):
        assert tuple(g.shape) == r.shape
        _close(g, r)
    # refs_before[0] is the input reference; later ones are refined
    np.testing.assert_array_equal(got[1][0].numpy(), ref)
    assert not np.allclose(got[1][1].numpy(), ref)
