"""The port's bf16 model against the JAX package's bf16 VoxelFormer on the
CPU: the tiny config (configs/verformer/vocc_tiny.py) with
``compute_dtype=bfloat16``, the same weights, the same two viewpoints.

Tolerance, rtol 2e-2 / atol 2e-2 on every output, and how it follows from
the casts both packages keep.  In bf16 each GEMM, LayerNorm output and
residual add rounds to 8 significant bits, a relative error of up to
2^-9 = 1.95e-3 per rounding; the two packages round at the same points but
sum in different orders, so their roundings differ and add up over the
1 encoder and 2 decoder layers and the heads' branches (about ten bf16
roundings in series on the longest path, 2e-2 relative).  The casts that
keep it there are the ones both packages make in fp32: the projection
(geometry.project_reference_points and the sampling offsets and attention
weights, computed from the query in fp32), the fp32 cross-camera sum of
the spatial cross-attention, and the fp32 accumulation of the
deformable-attention taps (the port's plain version and kernel read bf16
values and accumulate fp32; JAX's ``gather`` route does the same, its
``onehot`` route also rounds the interpolation weights to bf16, which
stays inside this bound).  A value dropped from fp32 to bf16 where JAX
keeps fp32 (or the reverse in front of a sum) moves an output by far more
than 2e-2: the fp32 model's outputs differ from the bf16 ones by 2e-2 to
4e-2 (measured here, in both packages).

The box centres are held in the space the model computes them in: the
sigmoid's [0, 1], before the fixed affine map to metres (x, y over 12 m,
z over 3.5 m), which would scale a bf16 rounding of the sigmoid by 12."""

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
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu_torch.config import (apply_cfg_options, build_ver_config,
                                      load_config)
from vln_ver_tpu_torch.convert import state_dict_from_jax
from vln_ver_tpu_torch.models import VoxelFormer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
RTOL = ATOL = 2e-2


@pytest.fixture(scope="module")
def setup():
    jcfg = apply_cfg_options(jax_load_config(CONFIG),
                             ["compute_dtype=bfloat16"])
    jver = dataclasses.replace(jax_build_ver_config(jcfg), dropout_rate=0.0)
    ver = dataclasses.replace(build_ver_config(apply_cfg_options(
        load_config(CONFIG), ["compute_dtype=bfloat16"])), dropout_rate=0.0)
    assert jver.dtype == jnp.bfloat16 and ver.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, ver.num_cams, ver.feat_h, ver.feat_w,
                                 ver.in_channels)).astype(np.float32)
    pos = (rng.uniform(-1.0, 1.0, (2, 3))
           * np.array([1, 1, 0.3])).astype(np.float32)
    w2p = np.stack([np.stack([
        jgeo.make_pinhole_world2pixel(70.0, deg * 360.0 / ver.num_cams, p)
        for deg in range(ver.num_cams)]) for p in pos]).astype(np.float32)
    inputs = (feats, w2p, pos)
    params = JaxVoxelFormer(jver).init(jax.random.PRNGKey(0),
                                       *inputs)["params"]
    prng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * prng.standard_normal(
            np.shape(a)).astype(np.float32), params)
    sd, not_ported = state_dict_from_jax(params, ver)
    assert not not_ported
    model = VoxelFormer(ver)
    model.load_state_dict(sd, strict=True)
    return jver, ver, params, model.eval(), inputs


def _jax(setup, impl, **kw):
    jver, _, params, _, inputs = setup
    return JaxVoxelFormer(dataclasses.replace(jver, deform_impl=impl)).apply(
        {"params": params}, *map(jnp.asarray, inputs), **kw)


def _close(got, ref, name):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_bf16_bev_embed_matches_jax(setup, impl):
    _, ver, _, model, inputs = setup
    ref = _jax(setup, impl, only_bev=True)
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, inputs), only_bev=True)
    assert got["bev_embed"].dtype == torch.bfloat16
    assert ref["bev_embed"].dtype == jnp.bfloat16
    _close(got["bev_embed"], ref["bev_embed"], "bev_embed")


def _normalised_centres(box, ver):
    """Codes 0, 1 (x, y) and 4 (z) of decoded boxes back in the
    sigmoid's [0, 1]: the inverse of the fixed map to metres."""
    box = np.array(box, np.float32)
    lo, hi = np.asarray(ver.pc_range[:3]), np.asarray(ver.pc_range[3:])
    for code, axis in ((0, 0), (1, 1), (4, 2)):
        box[..., code] = (box[..., code] - lo[axis]) / (hi[axis] - lo[axis])
    return torch.from_numpy(box)


@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_bf16_heads_match_jax(setup, impl):
    _, ver, _, model, inputs = setup
    ref = _jax(setup, impl)
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, inputs))
    for k in ("bev_embed", "all_cls_scores", "occupancy_preds"):
        _close(got[k], ref[k], k)
    _close(_normalised_centres(got["all_bbox_preds"].float().numpy(), ver),
           _normalised_centres(np.asarray(ref["all_bbox_preds"],
                                          np.float32), ver),
           "all_bbox_preds")
