"""The traffic pool repeats exactly for a seed and differs across seeds;
every seed gets the same sizes."""

import numpy as np
import torch

from verbench import traffic as T

from . import tiny


def _pool(seed):
    c = tiny.cell("vocc-train-b1")
    a, t = c.arch, c.traffic
    w2p, shift = T.cameras(a, t, seed)
    gt = T.ground_truth(a, t, seed)
    return (T.features(a, t, seed, "cpu"), w2p, shift,
            np.stack([g["occ_dense"] for g in gt]),
            np.stack([g["gt_boxes"] for g in gt]),
            T.order(seed, t["pool"], 1, 3))


def test_pool_repeats_for_a_seed():
    for x, y in zip(_pool(2147483901), _pool(2147483901)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_pool_differs_across_seeds_with_the_same_sizes():
    for x, y in zip(_pool(5), _pool(6)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        assert not np.array_equal(x, y)


def test_no_two_batches_alike():
    order = T.order(9, 64, 8, 10)
    rows = {tuple(sorted(r)) for r in order.tolist()}
    assert len(rows) == len(order)


def test_features_are_standard_normal():
    c = tiny.cell("ver36-full-b8")
    f = T.features(c.arch, {"pool": 16}, 3, "cpu")
    assert abs(float(f.mean())) < 0.05
    assert abs(float(f.std()) - 1.0) < 0.05
    assert f.dtype == torch.float32
