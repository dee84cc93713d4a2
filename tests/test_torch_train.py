"""The port's training path against the JAX package on the CPU, on shared
weights (a JAX parameter tree mapped through ``state_dict_from_jax``, which
is linear, so it maps gradients and AdamW moments too):

* ``compute_losses`` with the host matcher and the auction, with and
  without the layout branch (rtol 1e-4);
* every parameter's gradient against ``jax.grad`` (rtol 1e-3, atol 1e-5),
  and only the two inert tables get none;
* eight steps of ``make_train_step`` against JAX's at batch 1 and 2 (losses
  within rtol 2e-4, parameter drift within 2.5 % in relative L2: the bounds
  of tests/test_train_dynamics_parity.py);
* a JAX train state after 4 steps carried across by
  ``train_state_from_jax``, then 4 port steps, against JAX's 8;
* dropout (active in ``train()``, the identity in ``eval()``) and
  ``remat_encoder`` (the same loss and gradients within 1e-6).

The config is test_train_dynamics_parity's tiny CFG: fp32, dropout off
where JAX is compared."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import jax_params, port_model

from vln_ver_tpu import geometry
from vln_ver_tpu.models import VERConfig as JaxVERConfig
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.train import TrainConfig as JaxTrainConfig
from vln_ver_tpu.train import create_train_state as jax_create_train_state
from vln_ver_tpu.train import make_train_step as jax_make_train_step
from vln_ver_tpu.train.objective import compute_losses as jax_compute_losses
from vln_ver_tpu_torch.convert import state_dict_from_jax, train_state_from_jax
from vln_ver_tpu_torch.models import VERConfig
from vln_ver_tpu_torch.train import (TrainConfig, compute_losses,
                                     create_train_state, make_train_step)
from vln_ver_tpu_torch.utils.params import (NOGRAD_PARAM_KEYS, drift_rel_l2,
                                            grads_by_name, relu_masks)

torch.set_num_threads(1)

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


def _port_cfg(jcfg):
    return VERConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(VERConfig)
                        if f.name != "dtype"})


TCFG = _port_cfg(JCFG)
JCFG_LAYOUT = dataclasses.replace(JCFG, add_layout=True)
TCFG_LAYOUT = _port_cfg(JCFG_LAYOUT)
MAX_GT = 4
N_STEPS = 8
LR = 1e-4
TRAIN = dict(learning_rate=LR, weight_decay=0.01, warmup_steps=0,
             total_steps=10 ** 8, grad_clip_norm=300.0, matcher="host")


def make_batch(seed: int, bs: int, cfg=JCFG):
    """tests/test_train_dynamics_parity.py's batch, plus a layout box."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (bs, cfg.num_cams, cfg.feat_h, cfg.feat_w,
         cfg.in_channels)).astype(np.float32)
    w2p = np.stack([
        np.stack([geometry.make_pinhole_world2pixel(
            90.0, deg, [0.1 * b, -0.1, 1.0]) for deg in (0.0, 120.0, 240.0)])
        for b in range(bs)]).astype(np.float32)
    shift = rng.normal(0, 0.5, (bs, 3)).astype(np.float32)
    gt = np.zeros((bs, MAX_GT, 9), np.float32)
    gt[..., 0:2] = rng.uniform(-3, 3, (bs, MAX_GT, 2))
    gt[..., 2] = rng.uniform(0.0, 1.5, (bs, MAX_GT))
    gt[..., 3:6] = rng.uniform(0.3, 2.0, (bs, MAX_GT, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (bs, MAX_GT))
    labels = rng.integers(0, cfg.num_classes, (bs, MAX_GT)).astype(np.int32)
    valid = np.zeros((bs, MAX_GT), bool)
    for j in range(bs):
        valid[j, : int(rng.integers(1, MAX_GT + 1))] = True
    occ = rng.integers(0, cfg.occupancy_classes + 1,
                       (bs, cfg.voxel_num)).astype(np.int32)
    layout = np.zeros((bs, 1, 9), np.float32)
    layout[..., 0:3] = rng.uniform(-1, 1, (bs, 1, 3))
    layout[..., 3:6] = rng.uniform(2.0, 6.0, (bs, 1, 3))
    layout[..., 6] = rng.uniform(-np.pi, np.pi, (bs, 1))
    layout_valid = np.ones((bs, 1), bool)
    layout_valid[-1] = bs == 1
    return dict(features=feats, world2pixel=w2p, origin_shift=shift,
                gt_boxes=gt, gt_labels=labels, gt_valid=valid, occ_dense=occ,
                gt_layout=layout, layout_valid=layout_valid)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _jax_total(jcfg, matcher, batch):
    model = JaxVoxelFormer(jcfg)

    def f(params):
        outs = model.apply({"params": params}, batch["features"],
                           batch["world2pixel"], batch["origin_shift"])
        ld = jax_compute_losses(jcfg, outs, batch, matcher=matcher)
        return sum(ld.values()), ld
    return f


def _jax_value_and_grad(jcfg, matcher, batch, params):
    return jax.jit(jax.value_and_grad(_jax_total(jcfg, matcher, batch),
                                      has_aux=True))(params)


def _port_losses(model, cfg, batch, matcher):
    model.train()
    outs = model(batch["features"], batch["world2pixel"],
                 batch["origin_shift"])
    return compute_losses(cfg, outs, batch, matcher=matcher)


@pytest.fixture(scope="module")
def params():
    return jax_params(JCFG, seed=11)


@pytest.fixture(scope="module")
def params_layout():
    return jax_params(JCFG_LAYOUT, seed=12)


def _cfgs(layout):
    return (JCFG_LAYOUT, TCFG_LAYOUT) if layout else (JCFG, TCFG)


@pytest.fixture(scope="module")
def jax_host_runs(params, params_layout):
    """``get(layout)`` -> (batch, total, loss dict, gradients) of JAX with
    the host matcher at batch 2, each computed once for the module."""
    runs = {}

    def get(layout):
        if layout not in runs:
            jcfg, _ = _cfgs(layout)
            b = make_batch(2, 2, jcfg)
            (total, ld), grads = _jax_value_and_grad(
                jcfg, "host", _jax_batch(b),
                params_layout if layout else params)
            runs[layout] = (b, total, ld, jax.device_get(grads))
        return runs[layout]
    return get


@pytest.mark.parametrize("layout", [False, True], ids=["det_occ", "layout"])
@pytest.mark.parametrize("matcher", ["host", "auction"])
def test_compute_losses_matches_jax(params, params_layout, jax_host_runs,
                                    matcher, layout):
    jcfg, tcfg = _cfgs(layout)
    p = params_layout if layout else params
    if matcher == "host":
        b, _, ref, _ = jax_host_runs(layout)
    else:
        b = make_batch(1, 2, jcfg)
        _, ref = jax.jit(_jax_total(jcfg, matcher, _jax_batch(b)))(p)
    with torch.no_grad():
        got = _port_losses(port_model(p, tcfg), tcfg, _torch_batch(b),
                           matcher)
    # (jit returns the dict with its keys sorted)
    assert sorted(got) == sorted(ref)
    assert list(got)[:4] == ["d0.loss_cls", "d0.loss_bbox", "loss_cls",
                             "loss_bbox"]
    assert ("loss_layout" in got) == layout
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("layout", [False, True], ids=["det_occ", "layout"])
def test_every_gradient_matches_jax(params, params_layout, jax_host_runs,
                                    layout):
    """Each parameter's gradient of the total loss (host matcher, batch 2)
    against ``jax.grad``, mapped to the port's names; the ConvTranspose3d
    weight's through its flip and transpose, MHA's through the packing."""
    _, tcfg = _cfgs(layout)
    p = params_layout if layout else params
    b, total, _, jgrads = jax_host_runs(layout)
    ref, unmapped = state_dict_from_jax(jgrads, tcfg)
    assert not unmapped
    model = port_model(p, tcfg)
    loss = sum(_port_losses(model, tcfg, _torch_batch(b), "host").values())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(total), rtol=1e-4)
    got = grads_by_name(model)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_only_the_inert_tables_get_no_gradient(params):
    model = port_model(params, TCFG)
    b = _torch_batch(make_batch(3, 1))
    sum(_port_losses(model, TCFG, b, "auction").values()).backward()
    none = [n for n, p in model.named_parameters()
            if p.grad is None or not bool(p.grad.any())]
    assert none and all(any(k in n for k in NOGRAD_PARAM_KEYS)
                        for n in none), none


# ---- trajectories -----------------------------------------------------------

def _flat_sd(params):
    sd, _ = state_dict_from_jax(jax.device_get(params), TCFG)
    return sd


@pytest.fixture(scope="module", params=[1, 2], ids=["bs1", "bs2"])
def jax_run(request):
    """JAX: N_STEPS steps from a shared init; the state after 4 steps is
    kept for the carry-across test."""
    bs = request.param
    params0 = jax_params(JCFG, seed=20 + bs)
    batches = [make_batch(100 + i, bs) for i in range(N_STEPS)]
    jtc = JaxTrainConfig(**TRAIN)
    state = jax_create_train_state(JaxVoxelFormer(JCFG),
                                   {"params": params0}, jtc)
    step_fn = jax_make_train_step(JCFG, jtc, donate=False)
    rng = jax.random.PRNGKey(0)
    losses, mid = [], None
    for i, b in enumerate(batches):
        jb = {k: v for k, v in _jax_batch(b).items()
              if k not in ("gt_layout", "layout_valid")}
        state, metrics = step_fn(state, jb, jax.random.fold_in(rng, i))
        losses.append(float(metrics["loss"]))
        if i == 3:
            mid = jax.device_get((state.params, state.opt_state))
    return dict(bs=bs, params0=params0, batches=batches, losses=losses,
                final=_flat_sd(state.params), mid=mid)


def _port_steps(state, batches, first_step=0):
    step_fn = make_train_step(TCFG, state.tc)
    out = []
    for b in batches:
        m = step_fn(state, _torch_batch(b), seed=0)
        out.append(m)
    return out


def _check_drift(init, final_port, final_jax):
    """tests/test_train_dynamics_parity.py's bounds: every element within
    N_STEPS * lr, the drift vectors within 2.5 % in relative L2 globally."""
    for k in init:
        err = float((final_port[k].double() - final_jax[k].double())
                    .abs().max())
        assert err < N_STEPS * LR, (k, err)
    rel, worst = drift_rel_l2(init, final_port, final_jax)
    assert rel < 0.025, (rel, worst)


def test_eight_steps_match_jax(jax_run):
    model = port_model(jax_run["params0"], TCFG)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, TrainConfig(**TRAIN))
    metrics = _port_steps(state, jax_run["batches"])
    losses = [float(m["loss"]) for m in metrics]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=2e-4)
    assert abs(losses[0] - losses[-1]) > 1e-4
    assert all(float(m["grad_norm"]) > 0 and float(m["sca_overflow"]) == 0
               for m in metrics)
    assert state.step == N_STEPS
    _check_drift(init, model.state_dict(), jax_run["final"])
    # the gradient-free tables only decayed, as optax decays them
    for k, v in model.state_dict().items():
        if any(s in k for s in NOGRAD_PARAM_KEYS):
            bound = init[k].abs() * (LR * 0.01) * (N_STEPS + 1) + 1e-12
            assert bool(((v - init[k]).abs() <= bound).all()), k
            np.testing.assert_allclose(v.numpy(), jax_run["final"][k].numpy(),
                                       rtol=1e-6, atol=1e-12, err_msg=k)


def test_state_carried_across_from_jax(jax_run):
    """JAX's state after 4 steps (parameters, AdamW moments and count)
    through ``train_state_from_jax``, then the last 4 batches on the port:
    the same losses and final parameters as JAX's 8 steps."""
    params, opt_state = jax_run["mid"]
    state = train_state_from_jax(params, opt_state, TCFG,
                                 TrainConfig(**TRAIN))
    assert state.step == 4
    metrics = _port_steps(state, jax_run["batches"][4:])
    np.testing.assert_allclose([float(m["loss"]) for m in metrics],
                               jax_run["losses"][4:], rtol=2e-4)
    init = {k: v for k, v in state_dict_from_jax(
        jax_run["params0"], TCFG)[0].items()}
    _check_drift(init, state.model.state_dict(), jax_run["final"])


# ---- dropout and remat ------------------------------------------------------

def _dropout_model(params, **kw):
    cfg = dataclasses.replace(TCFG, dropout_rate=0.1, **kw)
    return port_model(params, cfg), cfg


def test_dropout_acts_in_train_mode_only(params):
    """In ``eval()`` a model with dropout 0.1 gives JAX's deterministic
    forward (as the inference parity tests hold it); in ``train()`` the outputs
    move, and a seed fixes them."""
    model, _ = _dropout_model(params)
    b = make_batch(4, 1)
    x = [torch.from_numpy(b[k]) for k in ("features", "world2pixel",
                                          "origin_shift")]
    jcfg = dataclasses.replace(JCFG, dropout_rate=0.1)
    ref = jax.jit(JaxVoxelFormer(jcfg).apply)(
        {"params": params}, *(jnp.asarray(a.numpy()) for a in x))
    with torch.no_grad():
        ev = model.eval()(*x)
        runs = []
        for seed in (0, 0, 1):
            torch.manual_seed(seed)
            runs.append(model.train()(*x))
    for k in ("bev_embed", "all_cls_scores", "occupancy_preds"):
        np.testing.assert_allclose(ev[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=5e-5, err_msg=k)
        assert not torch.allclose(runs[0][k], ev[k]), k
        torch.testing.assert_close(runs[0][k], runs[1][k], rtol=0, atol=0)
        assert not torch.equal(runs[0][k], runs[2][k]), k


def test_remat_encoder_gives_the_same_loss_and_gradients(params):
    """With dropout on: the recomputation in the backward redraws the same
    masks, so the loss and every gradient agree within 1e-6."""
    b = _torch_batch(make_batch(5, 2))
    results = []
    for remat in (False, True):
        model, cfg = _dropout_model(params, remat_encoder=remat)
        torch.manual_seed(3)
        loss = sum(_port_losses(model, cfg, b, "host").values())
        loss.backward()
        results.append((float(loss), grads_by_name(model)))
    (l0, g0), (l1, g1) = results
    assert l1 == pytest.approx(l0, rel=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-6,
                                   msg=k)


def test_pinned_relu_masks_reproduce_a_run_and_count_flips(params):
    """``relu_masks``: a run on its own recorded masks is the same run; a
    run on masks with one element flipped counts at least that flip."""
    b = _torch_batch(make_batch(6, 1))
    masks, out = [], []
    for pin in (None, "same", "flipped"):
        model = port_model(params, TCFG)
        if pin == "flipped":
            masks = [m.clone() for m in masks]
            masks[0].view(-1)[0] = ~masks[0].view(-1)[0]
        with relu_masks(model, record=masks if pin is None else None,
                        pin=None if pin is None else masks) as flips:
            loss = sum(_port_losses(model, TCFG, b, "host").values())
        loss.backward()
        out.append((loss.item(), grads_by_name(model), flips[0]))
    assert len(masks) > 0 and out[0][2] == out[1][2] == 0
    # (the flip moves later pre-activations too, which may then differ)
    assert out[1][0] == out[0][0] and out[2][2] >= 1
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], g, rtol=0, atol=0, msg=k)
