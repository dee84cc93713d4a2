"""Gradients of the port's 2D deformable attention against the JAX
package on the CPU, and the backward kernel's launch planner.

On a CPU tensor ``ms_deform_attn_2d_fused`` takes the plain version, whose
autograd is the reference the CUDA backward kernel is held to on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 3).  Here all three input
gradients (value, locations, weights) are held against ``jax.grad`` of the
JAX gather form and of ``ms_deform_attn_2d_pallas`` in interpret mode,
which runs its custom VJP ``_bwd`` (the one-hot XLA form), at the cases
and tolerance of tests/test_deform_variants.py (rtol 1e-3, atol 1e-4),
plus far-out (+-30) locations and a 10 x 20 map.  The backward kernel's
planner is checked here too, and its cut of the work is replayed CTA by
CTA with the kernel's formulas against the plain version's autograd."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vln_ver_tpu.ops.pallas_deform as pd
from vln_ver_tpu.ops import ms_deform_attn_2d as jax_deform
from vln_ver_tpu_torch.ops.deform_cuda import (BWD_BARRIER_BYTES, BWD_SLICE,
                                              BWD_SUM_LIST_BYTES,
                                              BWD_VALUE_LIST_BYTES, BWD_WARPS,
                                              MAX_SMEM_BYTES, SM_SMEM_BYTES,
                                              backward_cta_work,
                                              backward_sm_loads,
                                              ms_deform_attn_2d_fused,
                                              plan_backward)

torch.set_num_threads(1)

CASES = {
    "test_deform_variants": dict(seed=3, bs=2, nq=13),
    "far_out": dict(seed=7, bs=2, nq=13, lo=-30.0, hi=30.0),
    "map_10x20": dict(seed=8, bs=2, nq=13, h=10, w=20),
}


def _case(seed=0, bs=4, heads=4, dim=16, nq=57, pts=8, h=14, w=14,
          lo=-0.1, hi=1.1):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((bs, h * w, heads, dim)).astype(np.float32)
    locs = rng.uniform(lo, hi, (bs, nq, heads, 1, pts, 2)).astype(np.float32)
    wraw = rng.standard_normal((bs, nq, heads, pts)).astype(np.float32)
    wsm = (np.exp(wraw) / np.exp(wraw).sum(-1, keepdims=True)).reshape(
        bs, nq, heads, 1, pts)
    g = rng.standard_normal((bs, nq, heads * dim)).astype(np.float32)
    return v, locs, wsm, g, ((h, w),)


def _port_grads(v, locs, wsm, g, hw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (v, locs, wsm)]
    out = ms_deform_attn_2d_fused(ts[0], hw, ts[1], ts[2])
    out.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in ts]


def _jax_grads(fn, v, locs, wsm, g, hw):
    def f(v, l, w):
        return jnp.sum(fn(v, hw, l, w) * g)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(v), jnp.asarray(locs),
                                          jnp.asarray(wsm))


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pd.pl, "pallas_call", interp)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("form", ["gather", "pallas_bwd"])
def test_plain_gradients_match_jax(name, form, request):
    if form == "pallas_bwd":
        request.getfixturevalue("interpret")
        fn = pd.ms_deform_attn_2d_pallas
    else:
        fn = jax_deform
    v, locs, wsm, g, hw = _case(**CASES[name])
    got = _port_grads(v, locs, wsm, g, hw)
    ref = _jax_grads(fn, v, locs, wsm, g, hw)
    for label, a, b in zip(("dvalue", "dlocations", "dweights"), got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-4,
                                   err_msg=label)
    if name == "far_out":
        # most taps fall outside the map and contribute nothing
        assert (got[2] == 0).mean() > 0.5


# ---- the backward kernel's launch planner (plain Python) ------------------

PAIRS_CASES = [
    (6, 8, 900, 196, 96, 132),      # the encoder at batch 1
    (24, 8, 900, 196, 96, 132),     # batch 4
    (1, 8, 57, 200, 96, 132),       # a 10 x 20 map, few queries
    (1, 1, 1, 1, 1, 1),
    (48, 8, 901, 196, 96, 132),
    (6, 8, 900, 196, 256, 132),     # d = 256
    (4, 4, 57, 196, 3, 132),        # d = 3: one ragged slice
    (4, 4, 65, 196, 40, 132),       # d = 40: a full and a ragged slice
]


@pytest.mark.parametrize("bs,heads,nq,hw,d,sms", PAIRS_CASES)
def test_backward_plan_covers_every_query_once(bs, heads, nq, hw, d, sms):
    """Along the kernel's walk (``backward_cta_work``) the value CTAs
    cover every (slot, head, channel) over all queries exactly once, and
    the sums CTAs every (slot, head, query) over all channels exactly
    once; each kind's shared memory fits."""
    for elt in (4, 2):
        plan = plan_backward(bs, heads, nq, hw, d, elt, sms)
        pairs = bs * heads
        assert plan.slices == -(-d // BWD_SLICE)
        assert plan.value_ctas == pairs * plan.slices * plan.qsplit
        assert plan.sum_ctas == pairs * plan.chunks
        # a cluster of at most 8 value CTAs, and whole clusters in the grid
        assert plan.qsplit in (1, 2, 4, 8) and plan.ctas % plan.qsplit == 0
        assert 0 <= plan.ctas - plan.value_ctas - plan.sum_ctas < plan.qsplit
        assert plan.chunk % BWD_WARPS == 0
        assert plan.chunk * plan.chunks >= nq > plan.chunk * (plan.chunks - 1)
        value = np.zeros((pairs, d, nq), int)
        sums = np.zeros((pairs, d, nq), int)
        for cta in range(plan.ctas):
            kind, pair, c0, c1, queries = backward_cta_work(plan, nq, d, cta)
            if kind == "value":
                # the CTAs of one cluster share one (pair, slice)
                assert backward_cta_work(plan, nq, d, cta - cta % plan.qsplit
                                         )[1:4] == (pair, c0, c1)
                assert 0 < c1 - c0 <= BWD_SLICE
                value[pair, c0:c1, queries] += 1
            elif kind == "sums":
                assert (c0, c1) == (0, d) and len(queries) > 0
                sums[pair, :, queries] += 1
            else:
                assert cta >= plan.value_ctas + plan.sum_ctas
        assert (value == 1).all() and (sums == 1).all()
        assert plan.acc_bytes == hw * BWD_SLICE * 4
        assert 1 <= plan.walkers <= BWD_WARPS
        assert plan.tile_bytes >= hw * plan.row_stride * elt
        assert plan.row_stride >= d and plan.row_stride * elt % 4 == 0
        assert plan.smem_bytes <= MAX_SMEM_BYTES
        assert plan.smem_bytes >= BWD_BARRIER_BYTES + max(
            plan.tile_bytes + BWD_WARPS * BWD_SUM_LIST_BYTES,
            plan.walkers * (plan.acc_bytes + BWD_VALUE_LIST_BYTES))


def test_backward_plan_without_dvalue_needs_no_tile():
    """Without dvalue there are no value CTAs and no dV slice; without
    dlocations and dweights no sums CTAs and no V tile."""
    plan = plan_backward(6, 8, 900, 196, 96, 4, 132, need_value=False)
    assert plan.value_ctas == 0 and plan.acc_bytes == 0
    assert plan.qsplit == 1 and plan.ctas == 48 * plan.chunks > 0
    plan = plan_backward(6, 8, 900, 196, 96, 4, 132, need_sums=False)
    assert plan.chunks == plan.chunk == plan.tile_bytes == 0
    assert plan.qsplit == 2    # 144 slices: two value CTAs an SM
    assert plan.ctas == plan.value_ctas == 48 * 3 * 2
    assert plan.walkers == 3    # three 25 KB copies: three CTAs an SM
    assert plan.smem_bytes == BWD_BARRIER_BYTES + 3 * (
        196 * BWD_SLICE * 4 + BWD_VALUE_LIST_BYTES)


def test_backward_plan_refuses_what_the_kernel_does_not_take():
    # a 24 x 24 x 128 bf16 tile (147 KB) fits now; 32 x 32 does not
    plan_backward(1, 4, 57, 24 * 24, 128, 2, 132)
    with pytest.raises(ValueError, match="shared memory"):
        plan_backward(1, 4, 57, 32 * 32, 128, 2, 132)
    with pytest.raises(ValueError, match="shared memory"):
        plan_backward(1, 4, 57, 24 * 24, 128, 4, 132)
    with pytest.raises(ValueError, match="shared memory"):   # the dV slice
        plan_backward(1, 4, 57, 48 * 48, 8, 4, 132, need_sums=False)
    assert plan_backward(1, 4, 57, 40 * 40, 8, 4, 132).walkers == 1
    with pytest.raises(ValueError, match="head_dim"):
        plan_backward(1, 4, 57, 196, 257, 4, 132)
    with pytest.raises(ValueError, match="empty"):
        plan_backward(1, 4, 0, 196, 96, 4, 132)
    with pytest.raises(ValueError, match="element size"):
        plan_backward(1, 4, 57, 196, 96, 8, 132)
    with pytest.raises(ValueError, match="nothing"):
        plan_backward(1, 4, 57, 196, 96, 4, 132, need_value=False,
                      need_sums=False)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("elt", [4, 2])
def test_backward_plan_balances_the_sms(batch, elt):
    """At the encoder's shape on 132 SMs no SM carries more than 15 % over
    its share of the modelled work (at batch 1 the 144 value CTAs, one per
    (slot, head, slice), put two on 12 SMs), and three CTAs fit on an
    SM."""
    bs, nq, d = 6 * batch, 900, 96
    plan = plan_backward(bs, 8, nq, 196, d, elt, 132)
    loads = backward_sm_loads(plan, nq, d, elt, 132)
    assert max(loads) <= 1.15 * sum(loads) / len(loads)
    assert 3 * (plan.smem_bytes + 1024) <= SM_SMEM_BYTES


def _taps(loc, H, W):
    """The four taps of each location as the kernel forms them: (ok, row,
    wy, wx, dx, dy), tap index 2 * dy + dx."""
    x = loc[..., 0] * W - 0.5
    y = loc[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    ax, ay = x - x0, y - y0
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            xt, yt = x0 + dx, y0 + dy
            ok = (xt >= 0) & (xt <= W - 1) & (yt >= 0) & (yt <= H - 1)
            row = torch.where(ok, yt * W + xt, torch.zeros_like(xt)).long()
            out.append((ok, row, ay if dy else 1 - ay, ax if dx else 1 - ax,
                        dx, dy))
    return out


def _backward_along_plan(v, loc, w, g, H, W, plan):
    """dvalue, dlocations and dweights computed CTA by CTA along the
    plan's walk with the kernel's arithmetic: a value CTA adds
    w * tapweight * g of its queries into its share of a dV slice, the
    shares of a cluster summed in rank order; a sums CTA forms each tap's
    dot product D with g over all channels and sums the four taps of a
    point into dweights and dlocations."""
    bs, hw, heads, d = v.shape
    nq = loc.shape[1]
    dv, dl, dw = (torch.full_like(t, float("nan")) for t in (v, loc, w))
    g4 = g.view(bs, nq, heads, d)
    for cta in range(plan.ctas):
        kind, pair, c0, c1, queries = backward_cta_work(plan, nq, d, cta)
        if kind == "pad":
            continue
        b, h = divmod(pair, heads)
        qs = torch.as_tensor(list(queries), dtype=torch.long)
        aw = w[b, qs, h, 0]                          # (q, P)
        gq = g4[b, qs, h]                            # (q, d)
        taps = _taps(loc[b, qs, h, 0], H, W)
        if kind == "value":
            # the cluster's ranks add their shares in rank order
            if cta % plan.qsplit == 0:
                dv[b, :, h, c0:c1] = 0.0
            acc = torch.zeros(hw, c1 - c0)
            for ok, row, wy, wx, _, _ in taps:
                add = (aw * wy * wx)[..., None] * gq[:, None, c0:c1]
                acc.index_add_(0, row[ok], add[ok])
            dv[b, :, h, c0:c1] += acc
        else:
            sw = sx = sy = 0.0
            for ok, row, wy, wx, dx, dy in taps:
                D = (gq[:, None, :] * v[b, row, h]).sum(-1)
                D = torch.where(ok, D, torch.zeros_like(D))
                sw = sw + wy * wx * D
                sx = sx + (wy if dx else -wy) * D
                sy = sy + (wx if dy else -wx) * D
            dw[b, qs, h, 0] = sw
            dl[b, qs, h, 0] = torch.stack([aw * W * sx, aw * H * sy], -1)
    return dv, dl, dw


@pytest.mark.parametrize("case,sms", [
    (dict(seed=3, bs=2, nq=13), 132),
    (dict(seed=4, bs=2, heads=2, nq=57, dim=40, pts=37), 4),   # P > 32
    (dict(seed=5, bs=2, nq=21, dim=3), 1),
    (dict(seed=7, bs=2, nq=13, lo=-30.0, hi=30.0), 132),        # far out
    (dict(seed=8, bs=2, nq=13, h=10, w=20), 2),
])
def test_backward_along_the_plan_matches_autograd(case, sms):
    """The kernel's split of the work (value CTAs by channel slice, sums
    CTAs by query chunk) and its per-tap formulas give autograd of the
    plain version, rtol 1e-5, atol 1e-5: dweights and dlocations are sums
    of O(1) terms that partly cancel, summed in another order."""
    v, locs, wsm, g, hw = _case(**case)
    (H, W), = hw
    bs, _, heads, d = v.shape
    plan = plan_backward(bs, heads, locs.shape[1], H * W, d, 4, sms)
    got = _backward_along_plan(*map(torch.from_numpy, (v, locs, wsm, g)),
                               H, W, plan)
    ref = _port_grads(v, locs, wsm, g, hw)
    for label, a, b in zip(("dvalue", "dlocations", "dweights"), got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=label)
