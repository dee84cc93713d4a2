"""The port's losses, matching costs, matchers, DETR targets, lr schedule
and optimizer against the JAX package on the CPU, on the same numpy
inputs: losses and costs within rtol 1e-5, matched indices and targets
exactly, the schedule at every step within rtol 1e-6 (float32 cosine), and
three optimizer updates within 1e-7 relative of the optax chain."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_ver_tpu import boxes as jboxes
from vln_ver_tpu import losses as jlosses
from vln_ver_tpu import matching as jmatching
from vln_ver_tpu.train import state as jstate
from vln_ver_tpu_torch import boxes, losses, matching
from vln_ver_tpu_torch.train import state as tstate

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


# ---- losses and costs -----------------------------------------------------

@pytest.mark.parametrize("avg_factor", [None, 0.0, 7.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_sigmoid_focal_loss_matches_jax(avg_factor, weighted):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (40, 6)).astype(np.float32)
    labels = rng.integers(0, 7, 40).astype(np.int32)    # 6 = background
    weight = rng.uniform(0, 2, 40).astype(np.float32) if weighted else None
    kw = dict(avg_factor=avg_factor, loss_weight=2.0)
    ref = jlosses.sigmoid_focal_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if weight is None else jnp.asarray(weight), **kw)
    got = losses.sigmoid_focal_loss(_t(logits), _t(labels),
                                    None if weight is None else _t(weight),
                                    **kw)
    _close(got, ref)


@pytest.mark.parametrize("avg_factor", [0.0, 3.0])
def test_weighted_l1_loss_matches_jax_with_nan_targets(avg_factor):
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(12, 10)).astype(np.float32)
    target = rng.normal(size=(12, 10)).astype(np.float32)
    target[2, 3] = np.nan
    target[5, 0] = np.inf
    weight = rng.uniform(size=(12, 10)).astype(np.float32)
    ref = jlosses.weighted_l1_loss(jnp.asarray(pred), jnp.asarray(target),
                                   jnp.asarray(weight), avg_factor, 0.25)
    got = losses.weighted_l1_loss(_t(pred), _t(target), _t(weight),
                                  avg_factor, 0.25)
    assert np.isfinite(float(got))
    _close(got, ref)


@pytest.mark.parametrize("avg_factor", [None, 0.0, 11.0])
def test_softmax_ce_loss_matches_jax(avg_factor):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (30, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 30).astype(np.int32)
    weight = rng.uniform(size=30).astype(np.float32)
    ref = jlosses.softmax_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(weight), avg_factor)
    got = losses.softmax_ce_loss(_t(logits), _t(labels), _t(weight),
                                 avg_factor)
    _close(got, ref)


def test_costs_match_jax_per_sample():
    rng = np.random.default_rng(3)
    cls = rng.normal(0, 2, (3, 20, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (3, 4)).astype(np.int32)
    pred = rng.normal(size=(3, 20, 8)).astype(np.float32)
    gt = rng.normal(size=(3, 4, 8)).astype(np.float32)
    fc = losses.focal_loss_cost(_t(cls), _t(labels), weight=2.0)
    bc = losses.bbox_l1_cost(_t(pred), _t(gt), weight=0.25)
    for i in range(3):
        _close(fc[i], jlosses.focal_loss_cost(jnp.asarray(cls[i]),
                                              jnp.asarray(labels[i]),
                                              weight=2.0))
        _close(bc[i], jlosses.bbox_l1_cost(jnp.asarray(pred[i]),
                                           jnp.asarray(gt[i]), weight=0.25))


@pytest.mark.parametrize("width", [7, 9])
def test_normalize_bbox_matches_jax(width):
    rng = np.random.default_rng(4)
    b = rng.uniform(0.2, 3.0, (2, 5, width)).astype(np.float32)
    b[..., 6] = rng.uniform(-np.pi, np.pi, (2, 5))
    _close(boxes.normalize_bbox(_t(b)), jboxes.normalize_bbox(jnp.asarray(b)))
    # and back: denormalize inverts it on the first 7 fields
    _close(boxes.denormalize_bbox(boxes.normalize_bbox(_t(b)))[..., :7],
           b[..., :7], atol=1e-6)


# ---- matchers and targets ---------------------------------------------------

def _costs(n, nq, ng, seed, n_pad=0, scale=5.0):
    rng = np.random.default_rng(seed)
    cost = (rng.standard_normal((n, nq, ng + n_pad)) * scale).astype(
        np.float32)
    if n_pad:   # padded columns just above the real maximum, per sample
        cost[..., ng:] = cost[..., :ng].max(axis=(1, 2))[:, None, None] + 1
    return cost


def _jax_each(fn, cost, **kw):
    return np.stack([np.asarray(fn(jnp.asarray(c), **kw)) for c in cost])


def test_hungarian_host_matches_jax():
    cost = _costs(3, 20, 6, 0, n_pad=2)
    got = matching.hungarian_host(_t(cost))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_each(jmatching.hungarian_host, cost))


AUCTION_CASES = {
    "square": dict(n=3, nq=8, ng=8, seed=1),
    "more_queries": dict(n=4, nq=30, ng=8, seed=2),
    "padded_columns": dict(n=3, nq=30, ng=8, seed=3, n_pad=4),
    "transposed": dict(n=3, nq=4, ng=7, seed=4),
}


@pytest.mark.parametrize("name", AUCTION_CASES)
def test_hungarian_auction_matches_jax(name):
    cost = _costs(**AUCTION_CASES[name])
    got = matching.hungarian_auction(_t(cost)).numpy()
    ref = _jax_each(jmatching.hungarian_auction, cost)
    np.testing.assert_array_equal(got, ref)
    # every column of a perfect matching is assigned, one-to-one
    nq, ng = cost.shape[1:]
    assert ((got >= 0).sum(axis=1) == min(nq, ng)).all()


@pytest.mark.parametrize("num_iters", [3, 9])
def test_hungarian_auction_at_its_cap_matches_jax(num_iters):
    """Near-tied costs (every column ranks the rows alike, within 1e-5, and
    one outlier sets a wide spread) make the columns outbid each other row
    by row, and a small iteration cap stops them: the columns still
    unassigned come back -1 on both sides, and the port, which checks for
    its end every 8 iterations, stops at the cap exactly."""
    rng = np.random.default_rng(5)
    rows = 1e-6 * np.arange(12, dtype=np.float32)
    cost = (1.0 + rows[None, :, None]
            + 1e-7 * rng.random((2, 12, 12))).astype(np.float32)
    cost[:, 11, 11] = -50.0
    got = matching.hungarian_auction(_t(cost), num_iters=num_iters).numpy()
    ref = _jax_each(jmatching.hungarian_auction, cost, num_iters=num_iters)
    np.testing.assert_array_equal(got, ref)
    assert (got < 0).any()


def test_build_detr_targets_matches_jax_with_unmatched_rows():
    rng = np.random.default_rng(6)
    nq, g = 10, 5
    rows = np.array([[3, -1, 7, 0, 9], [2, 4, -1, -1, 1]], np.int64)
    valid = np.array([[True, True, True, False, True],
                      [True, True, True, True, False]])
    labels = rng.integers(0, 4, (2, g)).astype(np.int32)
    gtb = rng.normal(size=(2, g, 9)).astype(np.float32)
    got = matching.build_detr_targets(_t(rows), _t(valid), _t(labels),
                                      _t(gtb), nq, 4)
    for i in range(2):
        ref = jmatching.build_detr_targets(
            jnp.asarray(rows[i].astype(np.int32)), jnp.asarray(valid[i]),
            jnp.asarray(labels[i]), jnp.asarray(gtb[i]), nq, 4)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b))
    # a -1 row never lands on the last query
    assert got[0][:, -1].tolist() == [labels[0, 4], 4]


# ---- schedule and optimizer -------------------------------------------------

@pytest.mark.parametrize("spe", [0, 3])
def test_lr_schedule_matches_jax_at_every_step(spe):
    kw = dict(learning_rate=2e-4, warmup_steps=5, total_steps=40,
              warmup_ratio=1.0 / 3.0, min_lr_ratio=1e-3, steps_per_epoch=spe)
    ref = jstate.make_lr_schedule(jstate.TrainConfig(**kw))
    got = tstate.make_lr_schedule(tstate.TrainConfig(**kw))
    steps = np.arange(0, 46)         # past total_steps: held at min_lr
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6)
    assert got(45) == pytest.approx(2e-4 * 1e-3, rel=1e-6)


def test_train_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(tstate.TrainConfig)]
            == [f.name for f in dataclasses.fields(jstate.TrainConfig)])
    assert tstate.TrainConfig() == tstate.TrainConfig(
        **dataclasses.asdict(jstate.TrainConfig()))


class _Tree(torch.nn.Module):
    def __init__(self, leaves):
        super().__init__()
        self.p = torch.nn.ParameterDict({k: torch.nn.Parameter(_t(v).clone())
                                         for k, v in leaves.items()})


@pytest.mark.parametrize("fused", [False, True])
def test_three_updates_match_the_optax_chain(fused):
    """A small tree through clip_by_global_norm -> adamw: the first two
    gradients exceed the clip norm, ``frozen`` never gets a gradient
    (optax decays it, so the port must too), and the schedule is live
    (warmup and cosine).  In float64 on both sides, so that the algebra is
    compared and not float32 rounding: parameters and moments within 1e-7
    relative (the schedule is float32 on both)."""
    rng = np.random.default_rng(7)
    leaves = {"a": rng.normal(size=(4, 3)), "b": rng.normal(size=(3,)),
              "frozen": rng.normal(size=(5,))}
    grads = [{"a": rng.normal(0, s, (4, 3)), "b": rng.normal(0, s, (3,))}
             for s in (20.0, 10.0, 0.1)]
    kw = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2,
              total_steps=6, grad_clip_norm=5.0)
    with jax.enable_x64(True):
        tx = jstate.make_optimizer(jstate.TrainConfig(**kw))
        params = {k: jnp.asarray(v) for k, v in leaves.items()}
        opt_state = tx.init(params)
        for g in grads:
            full = dict(g, frozen=np.zeros(5))
            upd, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in full.items()},
                                       opt_state, params)
            params = jax.tree.map(lambda p, u: p + u, params, upd)
        params = {k: np.asarray(v) for k, v in params.items()}
        adam = jax.tree.map(np.asarray, opt_state[1][0])

    tree = _Tree(leaves)
    state = tstate.create_train_state(
        tree, tstate.TrainConfig(**kw, fused_opt=fused))
    norms = []
    for g in grads:
        state.optimizer.zero_grad(set_to_none=True)
        for k, v in g.items():
            tree.p[k].grad = _t(v).clone()
        norms.append(float(state.apply_gradients()))
    assert state.step == 3
    np.testing.assert_allclose(norms[0], np.sqrt(sum(
        (v ** 2).sum() for v in grads[0].values())), rtol=1e-12)
    mom = state.optimizer.state
    for k in leaves:
        p = tree.p[k]
        assert p.dtype == torch.float64
        for got, ref in ((p.detach(), params[k]),
                         (mom[p]["exp_avg"], adam.mu[k]),
                         (mom[p]["exp_avg_sq"], adam.nu[k])):
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-7,
                                       atol=1e-7 * np.abs(ref).max(),
                                       err_msg=k)
    # the gradient-free leaf only decayed
    np.testing.assert_array_less(np.abs(tree.p["frozen"].detach().numpy()),
                                 np.abs(leaves["frozen"]))


@pytest.mark.parametrize("name,spe", [("vocc.py", 8), ("vocc_tiny.py", 4),
                                      ("get_occ.py", 100)])
def test_build_train_config_matches_jax(name, spe):
    import os

    from vln_ver_tpu.config import build_train_config as jbuild
    from vln_ver_tpu.config import load_config as jload
    from vln_ver_tpu_torch.config import build_train_config, load_config
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "verformer", name)
    ref = jbuild(jload(path), spe, matcher="host")
    got = build_train_config(load_config(path), spe, matcher="host")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_staged_batches_keeps_order_and_raises_in_the_consumer():
    from vln_ver_tpu_torch.train import staged_batches, to_device
    host = [{"features": np.full((1, 2), i, np.float32), "token": ["t"]}
            for i in range(5)]
    got = [b["features"][0, 0].item() for b in staged_batches(
        host, lambda b: to_device(b, torch.device("cpu")))]
    assert got == [0, 1, 2, 3, 4]
    assert list(staged_batches([], lambda b: b)) == []

    def bad(b):
        if b == 2:
            raise ValueError("placement failed")
        return b
    it = staged_batches(range(4), bad)
    assert next(it) == 0
    with pytest.raises(ValueError, match="placement failed"):
        list(it)


def test_global_norm_is_accurate_over_a_large_tensor():
    """The clip's norm over one 9.4M-element tensor (the size of
    voxel2bev's first weight) within 1e-6 of a float64 sum.  An fp32
    ``linalg.vector_norm`` on the CPU, the per-tensor route
    ``_foreach_norm`` takes there, accumulates the squares without
    pairwise summation and misses this by orders of magnitude."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        9_437_184).astype(np.float32) * 1e-3)
    small = torch.ones((3, 5))
    ref = np.sqrt(np.sum(np.square(g.numpy().astype(np.float64))) + 15.0)
    got = tstate.global_norm([g, small])
    assert got.dtype == torch.float32
    assert abs(float(got) - ref) <= 1e-6 * ref
