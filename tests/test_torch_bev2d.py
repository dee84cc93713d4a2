"""The port's BEVFormer-2D family and nuScenes reader against the JAX
package, fp32 on the CPU: ``rotate_bev`` (identity, periodicity, the
quarter turn, arbitrary angles), ``ego_motion_shift``, the pillar and BEV
reference points, the 2D temporal self-attention and the decoder's 2D
deformable attention (outputs and gradients against ``jax.grad``), the
whole ``BEVFormer2D`` with ``prev_bev`` and ``can_bus`` under the shipped
flags and the upstream ones, the nuScenes reader on the files JAX's
``make_synthetic_nuscenes`` writes, and a 3-frame temporal chain of two
scenes fed by it.  The deformable samplings go through
``ms_deform_attn_2d_fused``, the plain version on the CPU.  Tolerances:
rtol 1e-4 with atol 2e-5 on ``bev_embed`` and 5e-5 on the head outputs;
gradients rtol 1e-3 / atol 1e-5."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_ver_tpu import geometry as jgeo
from vln_ver_tpu.data import nuscenes as jnusc
from vln_ver_tpu.models import bev2d as jbev
from vln_ver_tpu_torch import geometry
from vln_ver_tpu_torch.convert import bev2d_state_dict_from_jax
from vln_ver_tpu_torch.convert.voxelformer import KeyMap, _flatten
from vln_ver_tpu_torch.data import nuscenes
from vln_ver_tpu_torch.models import bev2d

torch.set_num_threads(1)

KW = dict(bev_h=5, bev_w=5, embed_dims=32, num_heads=4, encoder_layers=2,
          decoder_layers=2, ffn_dim=64, num_query=6, num_cams=2, feat_h=4,
          feat_w=4, in_channels=32, dropout_rate=0.0)
# the reference as shipped (rotation only) and the upstream lineage
FLAGS = {"shipped": {}, "upstream": dict(use_shift=True, use_can_bus=True)}


def _close(got, ref, key="bev_embed", rtol=1e-4):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(ref), rtol=rtol,
        atol=2e-5 if key == "bev_embed" else 5e-5, err_msg=key)


def _draw(rng):
    """Flax-init-like random leaves from a numpy generator."""
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
    return draw


# ---- functions --------------------------------------------------------------

def test_rotate_bev_identity_periodicity_and_quarter_turn():
    h = w = 8
    bev = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, h * w, 3)).astype(np.float32))
    torch.testing.assert_close(bev2d.rotate_bev(bev, torch.zeros(1), h, w),
                               bev, atol=1e-5, rtol=0)
    x = bev
    for _ in range(4):
        x = bev2d.rotate_bev(x, torch.full((1,), 90.0), h, w)
    torch.testing.assert_close(x, bev, atol=1e-4, rtol=0)
    q2 = bev2d.rotate_bev(bev2d.rotate_bev(bev, torch.full((1,), 90.0), h,
                                           w), torch.full((1,), 90.0), h, w)
    torch.testing.assert_close(
        q2, bev2d.rotate_bev(bev, torch.full((1,), 180.0), h, w), atol=1e-4,
        rtol=0)
    # a quarter turn counter-clockwise in array coordinates moves the
    # cell right of the centre to the one above it
    g = torch.zeros((1, 7 * 7, 1))
    g[0, 3 * 7 + 5, 0] = 1.0
    out = bev2d.rotate_bev(g, torch.full((1,), 90.0), 7, 7).reshape(7, 7)
    assert divmod(int(out.argmax()), 7) == (1, 3)
    assert abs(float(out.max()) - 1.0) < 1e-5


def test_rotate_bev_and_ego_motion_shift_match_jax():
    rng = np.random.default_rng(1)
    bev = rng.standard_normal((3, 5 * 6, 4)).astype(np.float32)
    angle = np.array([-37.5, 12.0, 200.0], np.float32)
    _close(bev2d.rotate_bev(torch.from_numpy(bev), torch.from_numpy(angle),
                            5, 6),
           jbev.rotate_bev(jnp.asarray(bev), jnp.asarray(angle), 5, 6))
    cfg, jcfg = bev2d.BEV2DConfig(**KW), jbev.BEV2DConfig(**KW)
    can_bus = rng.standard_normal((4, 18)).astype(np.float32)
    can_bus[0] = 0.0
    got = bev2d.ego_motion_shift(torch.from_numpy(can_bus), cfg)
    _close(got, jbev.ego_motion_shift(jnp.asarray(can_bus), jcfg))
    assert not got[0].any()
    # 1 m along +x at ego yaw 0 moves the grid by 1 m / 12 m in x
    one = np.zeros((1, 18), np.float32)
    one[0, 0] = 1.0
    np.testing.assert_allclose(
        bev2d.ego_motion_shift(torch.from_numpy(one), cfg).numpy(),
        [[0.0, 1.0 / cfg.grid_length[0] / cfg.bev_h]], atol=1e-7)


@pytest.mark.parametrize("z_extent", [None, 3.5])
def test_reference_points_match_jax(z_extent):
    np.testing.assert_allclose(
        geometry.pillar_reference_points(3, 5, 4, z_extent=z_extent).numpy(),
        np.asarray(jgeo.pillar_reference_points(3, 5, 4,
                                                z_extent=z_extent)),
        rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        geometry.bev_reference_points(3, 5).numpy(),
        np.asarray(jgeo.bev_reference_points(3, 5)))


# ---- the two 2D deformable attentions ---------------------------------------

def _module_pair(kind, seed):
    """A JAX module with random parameters and the port's module carrying
    them (value_proj, sampling_offsets, attention_weights, output_proj),
    with the module's call arguments for batch 3."""
    c, h, w, b, nq = 32, 5, 6, 3, 7
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if kind == "tsa2d":
        jm = jbev.TemporalSelfAttention2D(embed_dims=c, num_heads=4,
                                          num_points=4, dropout_rate=0.0)
        tm = bev2d.TemporalSelfAttention2D(c, 4, 1, 4, 2, dropout_rate=0.0)
        ref = rng.uniform(0, 1, (b, h * w, 1, 2)).astype(np.float32)
        args = dict(query=arr(b, h * w, c), prev_bev=arr(b, h * w, c),
                    ref_current=ref, ref_prev=ref + 0.15,
                    query_pos=arr(b, h * w, c), frame_query=arr(b, h * w, c))
    else:
        jm = jbev.CustomMSDeformableAttention2D(embed_dims=c, num_heads=4,
                                                num_points=4,
                                                dropout_rate=0.0)
        tm = bev2d.CustomMSDeformableAttention2D(c, 4, 1, 4,
                                                 dropout_rate=0.0)
        args = dict(query=arr(b, nq, c), value=arr(b, h * w, c),
                    reference_points=rng.uniform(
                        -0.1, 1.1, (b, nq, 1, 2)).astype(np.float32),
                    query_pos=arr(b, nq, c))
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), spatial_shapes=((h, w),),
                        **jargs))["params"]
    params = jax.tree_util.tree_map_with_path(_draw(rng), shapes)
    keys = KeyMap()
    for name in ("value_proj", "sampling_offsets", "attention_weights",
                 "output_proj"):
        keys.lin(name, name)
    sd, unmapped = keys.convert(_flatten(params))
    assert not unmapped
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm, args, ((h, w),)


@pytest.mark.parametrize("kind", ["tsa2d", "decoder_cross_attn"])
def test_2d_deformable_attention_and_gradients_match_jax(kind):
    """Output, and the gradient of a scalar of it with respect to every
    parameter and every input, against JAX."""
    jm, params, tm, args, spatial = _module_pair(kind, seed=3)
    cot = np.random.default_rng(4).standard_normal(
        (3,) + args["query"].shape[1:]).astype(np.float32)

    def jloss(p, a):
        out = jm.apply({"params": p}, spatial_shapes=spatial, **a)
        return jnp.sum(out * cot), out

    (_, ref), (gp, ga) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in args.items()})
    targs = {k: torch.from_numpy(v).requires_grad_()
             for k, v in args.items()}
    out = tm(spatial_shapes=spatial, **targs)
    _close(out, ref)
    (out * torch.from_numpy(cot)).sum().backward()
    keys = KeyMap()
    for name in ("value_proj", "sampling_offsets", "attention_weights",
                 "output_proj"):
        keys.lin(name, name)
    gref, _ = keys.convert(_flatten(jax.device_get(gp)))
    for name, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), gref[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    for k, t in targs.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ga[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_tsa2d_init_and_batch_fold():
    """The init's per-slot directional bias equals flax's; without
    ``prev_bev`` both slots are the query; each sample of a batch gets
    what it gets alone (the (sample, slot) rows fold batch-major)."""
    jm, params, tm, args, spatial = _module_pair("tsa2d", seed=5)
    fresh = bev2d.TemporalSelfAttention2D(32, 4, 1, 4, 2)
    fresh.init_sampling()
    jinit = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0),
                                      spatial_shapes=spatial, **a))(
        {k: jnp.asarray(v) for k, v in args.items()})
    np.testing.assert_array_equal(
        fresh.sampling_offsets.bias.detach().numpy(),
        np.asarray(jinit["params"]["sampling_offsets"]["bias"]))
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    with torch.no_grad():
        none = tm(t["query"], None, t["ref_current"], t["ref_prev"], spatial)
        same = tm(t["query"], t["query"], t["ref_current"],
                  t["ref_current"], spatial)
        torch.testing.assert_close(none, same, atol=1e-6, rtol=0)
        whole = tm(spatial_shapes=spatial, **t)
        for i in range(3):
            one = tm(spatial_shapes=spatial,
                     **{k: v[i:i + 1] for k, v in t.items()})
            torch.testing.assert_close(one, whole[i:i + 1], atol=2e-6,
                                       rtol=1e-5)


# ---- the model --------------------------------------------------------------

def _models(flags, seed=0):
    """(JAX config, port config, JAX params, the port's model, the jitted
    JAX forward)."""
    jcfg = jbev.BEV2DConfig(**KW, **flags)
    tcfg = bev2d.BEV2DConfig(**KW, **flags)
    b, cams = 1, tcfg.num_cams
    x = (jnp.zeros((b, cams, 4, 4, 32)), jnp.tile(jnp.eye(4), (b, cams, 1, 1)),
         jnp.zeros((b, 3)))
    shapes = jax.eval_shape(
        lambda: jbev.BEVFormer2D(jcfg).init(
            jax.random.PRNGKey(0), *x, can_bus=jnp.zeros((b, 18)),
            prev_bev=jnp.zeros((b, jcfg.bev_num, 32))))["params"]
    params = jax.tree_util.tree_map_with_path(
        _draw(np.random.default_rng(seed)), shapes)
    model = bev2d.BEVFormer2D(tcfg)
    model.load_state_dict(bev2d_state_dict_from_jax(params, tcfg),
                          strict=True)
    fwd = jax.jit(lambda p, f, w, s, c, prev, only_bev: jbev.BEVFormer2D(
        jcfg).apply({"params": p}, f, w, s, can_bus=c, prev_bev=prev,
                    only_bev=only_bev), static_argnames="only_bev")
    return jcfg, tcfg, params, model.eval(), fwd


@pytest.fixture(scope="module", params=list(FLAGS))
def models(request):
    return (request.param,) + _models(FLAGS[request.param])


def _frames(tmp_path, t_len=3):
    """Two synthetic nuScenes scenes of ``t_len`` frames written by the
    JAX package, read by the port's reader: (JAX's reader, the port's)."""
    ann = jnusc.make_synthetic_nuscenes(
        str(tmp_path), num_scenes=2, samples_per_scene=t_len,
        num_cams=KW["num_cams"], feat_hw=KW["feat_h"],
        feat_dim=KW["in_channels"], seed=2)
    kw = dict(num_cams=KW["num_cams"], feat_hw=KW["feat_h"], max_gt=8)
    return (jnusc.NuScenesAdapter(ann, str(tmp_path), **kw),
            nuscenes.NuScenesAdapter(ann, str(tmp_path), **kw))


def test_bevformer2d_forward_matches_jax(models):
    """Batch 2 with ``can_bus`` (a yaw change, so ``rotate_prev_bev``
    turns the previous grid) and ``prev_bev``."""
    name, jcfg, tcfg, params, model, fwd = models
    rng = np.random.default_rng(6)
    f = rng.standard_normal((2, 2, 4, 4, 32)).astype(np.float32)
    w = np.stack([np.stack([
        jgeo.make_pinhole_world2pixel(70.0, 180.0 * c + 17.0,
                                      (0.1 * b, -0.2, 0.3))
        for c in range(2)]) for b in range(2)]).astype(np.float32)
    s = rng.normal(0, 0.3, (2, 3)).astype(np.float32)
    can_bus = rng.standard_normal((2, 18)).astype(np.float32)
    prev = rng.standard_normal((2, tcfg.bev_num, 32)).astype(np.float32)
    ref = fwd(params, *map(jnp.asarray, (f, w, s, can_bus, prev)),
              only_bev=False)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (f, w, s)),
                    can_bus=torch.from_numpy(can_bus),
                    prev_bev=torch.from_numpy(prev))
        turned = model(*map(torch.from_numpy, (f, w, s)),
                       can_bus=torch.from_numpy(can_bus * 0),
                       prev_bev=torch.from_numpy(prev))
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k], k)
    # the can-bus reaches the output (the rotation, and the MLP upstream)
    assert not torch.allclose(got["bev_embed"], turned["bev_embed"])
    assert hasattr(model.transformer, "can_bus_mlp") == (name == "upstream")


def test_temporal_chain_over_nuscenes_scenes(models, tmp_path):
    """Three frames of two synthetic scenes (batch 2): each frame's BEV
    (only_bev) with the previous frame's in the TSA queue and the can-bus
    alignment, then the last frame's full forward, against JAX on the
    frames JAX's reader yields."""
    name, jcfg, tcfg, params, model, fwd = models
    jds, tds = _frames(tmp_path)
    t_len = len(tds) // 2
    jprev = tprev = None
    for t in range(t_len):
        js = jnusc.collate([jds[t], jds[t_len + t]])
        ts = nuscenes.collate([tds[t], tds[t_len + t]])
        only_bev = t < t_len - 1
        jout = fwd(params, *(jnp.asarray(js[k]) for k in (
            "features", "world2pixel", "origin_shift", "can_bus")), jprev,
            only_bev=only_bev)
        with torch.no_grad():
            tout = model(*(torch.from_numpy(ts[k]) for k in (
                "features", "world2pixel", "origin_shift")),
                can_bus=torch.from_numpy(ts["can_bus"]), prev_bev=tprev,
                only_bev=only_bev)
        if only_bev:
            _close(tout, jout)
            jprev, tprev = jout, tout
    for k in jout:
        _close(tout[k], jout[k], k)


# ---- the nuScenes reader ----------------------------------------------------

def test_nuscenes_reader_matches_jax(tmp_path):
    """On the files JAX's ``make_synthetic_nuscenes`` writes, the port's
    reader yields JAX's samples (gravity-centre boxes included) and the
    same temporal links; the port's own writer gives the same records,
    and its files read back through the port's reader as JAX's do."""
    jds, tds = _frames(tmp_path / "jax")
    assert len(tds) == len(jds) == 6
    for i in range(6):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], str):
                assert a[k] == b[k], k
            else:
                np.testing.assert_array_equal(a[k], b[k], k)
        assert tds.prev_index(i) == jds.prev_index(i)
    assert tds.prev_index(3) is None and tds.prev_index(5) == 4
    raw = tds.infos[0]["gt_boxes"]
    n = len(raw)
    np.testing.assert_allclose(tds[0]["gt_boxes"][:n, 2],
                               raw[:, 2] + 0.5 * raw[:, 5])
    ann = nuscenes.make_synthetic_nuscenes(
        str(tmp_path / "port"), num_scenes=2, samples_per_scene=3,
        num_cams=KW["num_cams"], feat_hw=KW["feat_h"],
        feat_dim=KW["in_channels"], seed=2)
    with open(ann, "rb") as f:
        infos = pickle.load(f)
    for a, b in zip(jds.infos, infos):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    own = nuscenes.NuScenesAdapter(ann, str(tmp_path / "port"),
                                   num_cams=KW["num_cams"],
                                   feat_hw=KW["feat_h"], max_gt=8)
    batch = nuscenes.collate([own[1], own[5]])
    ref = jnusc.collate([jds[1], jds[5]])
    assert batch["token"] == ref["token"] and batch["prev"] == ref["prev"]
    for k in ("features", "world2pixel", "can_bus", "gt_boxes"):
        np.testing.assert_array_equal(batch[k], ref[k], k)


def test_multi_level_config_is_refused_on_cuda_tensors(monkeypatch):
    """The CUDA kernel samples one level: a BEV-2D config with two levels
    raises before any launch (a CPU tensor posing as a CUDA one)."""
    cfg = dataclasses.replace(bev2d.BEV2DConfig(**KW), num_levels=2)
    model = bev2d.BEVFormer2D(cfg)
    feats = torch.zeros((1, 2, 4, 4, 32))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match="one level"):
        model(feats, torch.zeros((1, 2, 4, 4)), torch.zeros((1, 3)))
