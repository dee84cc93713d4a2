"""The port's temporal VER model against the JAX package, fp32 on the CPU:
the voxel temporal self-attention (TSA) module without and with a
previous grid, shift and frame query; a TSA ``VoxelFormer`` (``only_bev``
and the full forward) with ``prev_bev`` and ``tsa_shift``;
``obtain_history_bev`` over three frames with moving origins; every
gradient of the train loss of a TSA config with ``decoder_on_bev`` (the
card's phase 11 step) through ``make_train_step``; the converter's strict
load with the reference's temporal names.  Tolerances
are the JAX package's own against its torch oracle
(tests/test_convert_voxelformer.py): rtol 1e-4 with atol 2e-5 on
``bev_embed`` and 5e-5 on the head outputs; gradients rtol 1e-3 / atol
1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import JCFG, TCFG, jax_params, port_model
from test_torch_head import _inputs
from test_torch_train import (TRAIN, _jax_batch, _jax_value_and_grad,
                              _port_cfg, _torch_batch, make_batch)

from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.models.temporal import (
    VoxelTemporalSelfAttention as JaxTSA)
from vln_ver_tpu_torch.convert import state_dict_from_jax
from vln_ver_tpu_torch.convert.voxelformer import KeyMap, _flatten
from vln_ver_tpu_torch.models import VoxelFormer, build_model
from vln_ver_tpu_torch.models.attention import SpatialCrossAttention
from vln_ver_tpu_torch.models.temporal import VoxelTemporalSelfAttention
from vln_ver_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_train_step)
from vln_ver_tpu_torch.utils.params import grads_by_name

torch.set_num_threads(1)

JTSA = dataclasses.replace(JCFG, use_temporal_self_attn=True)
TTSA = _port_cfg(JTSA)
OUTPUTS = ("bev_embed", "all_cls_scores", "all_bbox_preds",
           "occupancy_preds")


def _close(got, ref, key="bev_embed", rtol=1e-4):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(ref), rtol=rtol,
        atol=2e-5 if key == "bev_embed" else 5e-5, err_msg=key)


@pytest.fixture(scope="module")
def params():
    return jax_params(JTSA, seed=5)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params, TTSA)


@pytest.fixture(scope="module")
def jax_forward():
    """The JAX TSA VoxelFormer, jitted once for the module."""
    return jax.jit(
        lambda p, f, w, s, prev, shift, only_bev: JaxVoxelFormer(JTSA).apply(
            {"params": p}, f, w, s, prev_bev=prev, tsa_shift=shift,
            only_bev=only_bev), static_argnames="only_bev")


def _prev_and_shift(seed, b=2):
    rng = np.random.default_rng(seed)
    prev = rng.standard_normal((b, JTSA.bev_num, JTSA.embed_dims))
    return (prev.astype(np.float32),
            rng.uniform(-0.2, 0.2, (b, 3)).astype(np.float32))


# ---- the module -------------------------------------------------------------

def _tsa_pair(seed):
    """A JAX TSA with perturbed init parameters and the port's module
    carrying them."""
    c, grid = 32, ((2, 3, 4),)
    jm = JaxTSA(embed_dims=c, num_heads=4, num_points=3, dropout_rate=0.0,
                deform_impl="gather")
    nq = 24
    q = jnp.zeros((1, nq, c))
    ref = jnp.zeros((1, nq, 1, 3))
    p = jax.jit(lambda q, r: jm.init(jax.random.PRNGKey(0), q, None, r,
                                     grid))(q, ref)["params"]
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(
            a.shape).astype(np.float32), p)
    keys = KeyMap()
    for name in ("value_proj", "sampling_offsets", "attention_weights",
                 "output_proj"):
        keys.lin(name, name)
    sd, unmapped = keys.convert(_flatten(p))
    assert not unmapped
    tm = VoxelTemporalSelfAttention(c, 4, 1, 3, 2, dropout_rate=0.0)
    tm.load_state_dict(sd, strict=True)
    return jm, p, tm, grid, nq


@pytest.mark.parametrize("case", ["no_prev", "prev", "prev_shift_frame"])
def test_tsa_module_matches_jax(case):
    jm, p, tm, grid, nq = _tsa_pair(1)
    rng = np.random.default_rng(2)

    def arr(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    b = 3
    kw = dict(query=arr(b, nq, 32), query_pos=arr(b, nq, 32, scale=0.5),
              reference_points=rng.uniform(0, 1, (b, nq, 1, 3)).astype(
                  np.float32))
    if case != "no_prev":
        kw["prev_bev"] = arr(b, nq, 32)
    if case == "prev_shift_frame":
        kw["frame_query"] = arr(b, nq, 32)
        kw["shift"] = rng.uniform(-0.3, 0.3, (b, 3)).astype(np.float32)
    kw.setdefault("prev_bev", None)
    ref = jax.jit(lambda a: jm.apply({"params": p}, spatial_shapes=grid,
                                     **a))(
        {k: v if v is None else jnp.asarray(v) for k, v in kw.items()})
    got = tm(spatial_shapes=grid, **{k: v if v is None else
                                     torch.from_numpy(v)
                                     for k, v in kw.items()})
    _close(got, ref)


def test_tsa_init_matches_flax_heads_major_bias():
    """The offsets' bias is the directional grid per queue slot within
    each head, as flax initialises it; kernels and attention weights
    zero."""
    jm = JaxTSA(embed_dims=32, num_heads=4, num_points=3)
    p = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 32)),
                                None, jnp.zeros((1, 6, 1, 3)),
                                ((1, 2, 3),)))()["params"]
    tm = VoxelTemporalSelfAttention(32, 4, 1, 3, 2)
    tm.init_sampling()
    np.testing.assert_array_equal(
        tm.sampling_offsets.bias.detach().numpy(),
        np.asarray(p["sampling_offsets"]["bias"]))
    assert not tm.sampling_offsets.weight.any()
    assert not tm.attention_weights.weight.any()
    assert not tm.attention_weights.bias.any()


# ---- the model --------------------------------------------------------------

@pytest.mark.parametrize("only_bev", [True, False], ids=["only_bev", "full"])
def test_tsa_voxelformer_matches_jax(params, model, jax_forward, only_bev):
    f, w, s = _inputs(2, seed=4)
    prev, shift = _prev_and_shift(6)
    ref = jax_forward(params, *map(jnp.asarray, (f, w, s, prev, shift)),
                      only_bev=only_bev)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (f, w, s)),
                    prev_bev=torch.from_numpy(prev),
                    tsa_shift=torch.from_numpy(shift), only_bev=only_bev)
    for k in OUTPUTS[:1] if only_bev else OUTPUTS:
        _close(got[k], ref[k], k)
    # the previous grid and the shift both reach the output
    with torch.no_grad():
        plain = model(*map(torch.from_numpy, (f, w, s)), only_bev=True)
        unshifted = model(*map(torch.from_numpy, (f, w, s)),
                          prev_bev=torch.from_numpy(prev), only_bev=True)
    assert not torch.allclose(plain["bev_embed"], unshifted["bev_embed"])
    assert not torch.allclose(unshifted["bev_embed"], got["bev_embed"])


def test_obtain_history_bev_matches_jax(params, model):
    """Three frames at moving origins: each frame's grid with the
    previous one in the TSA queue and the derived shift, no gradient."""
    t_len, b = 3, 2
    frames = [_inputs(b, seed=10 + t) for t in range(t_len)]
    feats, w2p, _ = (np.stack(x, axis=1) for x in zip(*frames))
    origins = np.cumsum(np.random.default_rng(3).uniform(
        -0.8, 0.8, (b, t_len, 3)), axis=1).astype(np.float32)
    ref = jax.jit(lambda p, f, w, o: JaxVoxelFormer(JTSA).apply(
        {"params": p}, f, w, o,
        method=JaxVoxelFormer.obtain_history_bev))(
            params, *map(jnp.asarray, (feats, w2p, origins)))
    model.train()
    got = model.obtain_history_bev(*map(torch.from_numpy,
                                        (feats, w2p, origins)))
    assert model.training      # the mode is restored
    model.eval()
    assert got.grad_fn is None and not got.requires_grad
    _close(got, ref)


# ---- training ---------------------------------------------------------------

def test_train_step_gradients_match_jax():
    """Every parameter's gradient of the total loss (host matcher, batch
    2) through the port's ``make_train_step`` against ``jax.grad``, for a
    TSA config with ``decoder_on_bev`` (mlp): the TSA's and voxel2bev's
    are nonzero."""
    jcfg = dataclasses.replace(JTSA, decoder_on_bev=True)
    tcfg = _port_cfg(jcfg)
    params = jax_params(jcfg, seed=13)
    batch = make_batch(2, 2, jcfg)
    (total, _), jgrads = _jax_value_and_grad(jcfg, "host", _jax_batch(batch),
                                             params)
    ref, unmapped = state_dict_from_jax(jax.device_get(jgrads), tcfg)
    assert not unmapped
    model = port_model(params, tcfg)
    tc = TrainConfig(**TRAIN)
    metrics = make_train_step(tcfg, tc)(create_train_state(model, tc),
                                        _torch_batch(batch), seed=1)
    np.testing.assert_allclose(float(metrics["loss"]), float(total),
                               rtol=1e-4)
    got = grads_by_name(model)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    tsa = [k for k in got if "encoder" in k and ".attentions.0." in k]
    v2b = [k for k in got if ".voxel2bev." in k]
    assert len(tsa) == 8 * jcfg.encoder_layers and len(v2b) == 8
    assert all(got[k].abs().sum() > 0 for k in tsa + v2b)


# ---- names ------------------------------------------------------------------

def test_tsa_converter_loads_strictly_with_reference_names(params):
    """attentions.0 is the TSA, attentions.1 the SCA, norms.{0,1,2}, as
    the reference's temporal operation order numbers them; the
    non-temporal names are unchanged."""
    sd, unmapped = state_dict_from_jax(params, TTSA)
    assert not unmapped
    model = VoxelFormer(TTSA)
    model.load_state_dict(sd, strict=True)
    layer = model.pts_bbox_head.transformer.encoder.layers[0]
    assert isinstance(layer.attentions[0], VoxelTemporalSelfAttention)
    assert isinstance(layer.attentions[1], SpatialCrossAttention)
    assert len(layer.norms) == 3
    enc = "pts_bbox_head.transformer.encoder.layers.1."
    for key in ("attentions.0.sampling_offsets.weight",
                "attentions.1.deformable_attention.value_proj.weight",
                "norms.2.bias"):
        assert enc + key in sd
    plain = VoxelFormer(TCFG).state_dict()
    assert enc + "attentions.0.deformable_attention.value_proj.weight" \
        in plain and enc + "norms.2.bias" not in plain
    # the positional encoding is live under TSA: the tree's tables, and
    # build_model draws them U[0, 1)
    pos = "pts_bbox_head.positional_encoding.z_embed.weight"
    np.testing.assert_array_equal(
        sd[pos].numpy(),
        params["pts_bbox_head"]["positional_encoding"]["z_embed"])
    drawn = build_model(TTSA, "cpu", seed=0).state_dict()[pos]
    assert 0.0 <= float(drawn.min()) and float(drawn.max()) < 1.0


def test_remat_encoder_with_tsa_gives_the_same_gradients(params):
    """``remat_encoder`` replays each TSA layer, its previous grid, shift
    and frame query included, in the backward: the same loss and
    gradients within 1e-6; the history roll stays outside autograd."""
    f, w, s = map(torch.from_numpy, _inputs(2, seed=4))
    prev, shift = map(torch.from_numpy, _prev_and_shift(6))
    results = []
    for remat in (False, True):
        model = port_model(params, dataclasses.replace(TTSA,
                                                       remat_encoder=remat))
        model.train()
        out = model(f, w, s, prev_bev=prev, tsa_shift=shift, only_bev=True)
        loss = out["bev_embed"].square().mean()
        loss.backward()
        results.append((float(loss), grads_by_name(model)))
        history = model.obtain_history_bev(f[:, None].expand(-1, 2, -1, -1,
                                                             -1, -1),
                                           w[:, None].expand(-1, 2, -1, -1,
                                                             -1), s[:, None]
                                           .expand(-1, 2, -1))
        assert history.grad_fn is None
    (l0, g0), (l1, g1) = results
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    tsa = 0
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
        tsa += "encoder" in k and ".attentions.0." in k and bool(g0[k].any())
    assert tsa > 0
