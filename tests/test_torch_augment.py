"""GridMask on the patch grid (``vln_ver_tpu_torch/augment.py``) against
``vln_ver_tpu/augment.py``: the mask built from JAX's own draws (the same
key split) equals JAX's output exactly; ``prob`` 0 and 1; the port's own
draws keep the band and phase rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_ver_tpu.augment import grid_mask_features as jax_grid_mask
from vln_ver_tpu_torch.augment import grid_mask_features, grid_mask_from_draws


def _features(seed=1, b=6):
    return np.random.default_rng(seed).standard_normal(
        (b, 2, 14, 14, 8)).astype(np.float32)


def _jax_draws(key, b, prob, max_period):
    """The draws inside vln_ver_tpu/augment.py, from the same split."""
    k_apply, k_d, k_ox, k_oy = jax.random.split(key, 4)
    apply = jax.random.uniform(k_apply, (b,)) < prob
    d = jax.random.randint(k_d, (b,), 2, max_period + 1)
    df = d.astype(jnp.float32)
    ox = jnp.floor(jax.random.uniform(k_ox, (b,)) * df).astype(jnp.int32)
    oy = jnp.floor(jax.random.uniform(k_oy, (b,)) * df).astype(jnp.int32)
    return [torch.from_numpy(np.asarray(a).astype(
        bool if a.dtype == bool else np.int64)) for a in (apply, d, ox, oy)]


@pytest.mark.parametrize("seed,prob,ratio,max_period", [
    (0, 0.7, 0.5, 8), (3, 1.0, 0.5, 8), (5, 1.0, 0.3, 5), (7, 0.5, 0.6, 14)])
def test_mask_from_jax_draws_equals_jax(seed, prob, ratio, max_period):
    feats = _features(seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_grid_mask(key, jnp.asarray(feats), ratio=ratio,
                                    prob=prob, max_period=max_period))
    draws = _jax_draws(key, feats.shape[0], prob, max_period)
    got = grid_mask_from_draws(torch.from_numpy(feats), *draws, ratio=ratio)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_prob_edges(prob):
    feats = _features()
    gen = torch.Generator().manual_seed(0)
    got = grid_mask_features(gen, torch.from_numpy(feats), prob=prob).numpy()
    ref = np.asarray(jax_grid_mask(jax.random.PRNGKey(0), jnp.asarray(feats),
                                   prob=prob))
    zero_t = np.abs(got).sum(axis=(1, 4)) == 0      # (B, H, W) patches
    zero_j = np.abs(ref).sum(axis=(1, 4)) == 0
    if prob == 0.0:
        np.testing.assert_array_equal(got, feats)
        np.testing.assert_array_equal(ref, feats)
    else:
        # every sample masked, never all of it, in both packages; a zeroed
        # patch is zeroed in every camera and channel
        for z in (zero_t, zero_j):
            assert z.any(axis=(1, 2)).all() and not z.all(axis=(1, 2)).any()
        assert ((got == 0) == zero_t[:, None, :, :, None]).all()


def test_port_draws_follow_the_band_and_phase_rules():
    """Over many samples: periods uniform on [2, max_period], phases in
    [0, d), the zeroed share of a masked sample (d - keep)^2 / d^2 on a
    grid a multiple of d, keep = round(d * ratio) clamped to [1, d - 1]."""
    b, max_period = 3000, 6
    feats = torch.ones(b, 1, 60, 60, 1)   # 60 = lcm(2..6)
    got = grid_mask_features(torch.Generator().manual_seed(4), feats,
                             prob=1.0, max_period=max_period)
    zero = (got[:, 0, :, :, 0] == 0).float().mean((1, 2)).numpy()
    share = {d: (d - min(max(int(d * 0.5 + 0.5), 1), d - 1)) ** 2 / d ** 2
             for d in range(2, max_period + 1)}
    periods = len(share)
    for s in set(share.values()):
        want = b * sum(v == s for v in share.values()) / periods
        assert abs(np.isclose(zero, s).sum() - want) < 0.1 * want, s
    assert np.isclose(zero[:, None], list(share.values())).any(1).all()
