"""Gradients of the port's 2D deformable attention against the JAX
package on the CPU, and the backward kernel's launch planner.

On a CPU tensor ``ms_deform_attn_2d_fused`` takes the plain version, whose
autograd is the reference the CUDA backward kernel is held to on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 3).  Here all three input
gradients (value, locations, weights) are held against ``jax.grad`` of the
JAX gather form and of ``ms_deform_attn_2d_pallas`` in interpret mode,
which runs its custom VJP ``_bwd`` (the one-hot XLA form), at the cases
and tolerance of tests/test_deform_variants.py (rtol 1e-3, atol 1e-4),
plus far-out (+-30) locations and a 10 x 20 map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vln_ver_tpu.ops.pallas_deform as pd
from vln_ver_tpu.ops import ms_deform_attn_2d as jax_deform
from vln_ver_tpu_torch.ops.deform_cuda import (BWD_MIN_CHUNK,
                                              MAX_SMEM_BYTES,
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

@pytest.mark.parametrize("bs,heads,nq,hw,d,sms", [
    (6, 8, 900, 196, 96, 132),      # the encoder at batch 1
    (24, 8, 900, 196, 96, 132),     # batch 4
    (1, 8, 57, 200, 96, 132),       # a 10 x 20 map, few queries
    (1, 1, 1, 1, 1, 1),
    (48, 8, 901, 196, 96, 132),
    (6, 8, 900, 196, 256, 132),     # d = 256
])
def test_backward_plan_covers_every_query_once(bs, heads, nq, hw, d, sms):
    plan = plan_backward(bs, heads, nq, hw, d, sms)
    assert plan.ctas == bs * heads * plan.chunks
    assert plan.chunk * plan.chunks >= nq > plan.chunk * (plan.chunks - 1)
    assert plan.chunks == 1 or plan.chunk >= BWD_MIN_CHUNK
    assert plan.smem_bytes == hw * d * 4 <= MAX_SMEM_BYTES
    covered = np.zeros(nq, int)
    for c in range(plan.chunks):
        covered[c * plan.chunk:(c + 1) * plan.chunk] += 1
    assert (covered == 1).all()


def test_backward_plan_without_dvalue_needs_no_tile():
    plan = plan_backward(6, 8, 900, 196, 96, 132, with_dvalue=False)
    assert plan.smem_bytes == 0


def test_backward_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        plan_backward(1, 4, 57, 24 * 24, 128, 132)
    with pytest.raises(ValueError, match="head_dim"):
        plan_backward(1, 4, 57, 196, 257, 132)
    with pytest.raises(ValueError, match="empty"):
        plan_backward(1, 4, 0, 196, 96, 132)
