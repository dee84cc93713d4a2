"""The plain reference against the port at vocc_tiny.py's widths, on the
CPU: the full forward (dense and sparse lift), the cells' runs (full
forward, one train step and the dump layout) coming out correct."""

import numpy as np
import pytest
import torch

from verbench import traffic as T
from verbench.compare import spread_error
from verbench.program import build_model
from verbench.reference.arch import make_weights
from verbench.reference.model import Ref

from . import tiny


@pytest.mark.parametrize("capacity", [0, 24])
def test_forward_matches_port(capacity):
    c = tiny.cell("ver36-full-b8", dtype="float32",
                  sca_query_capacity=capacity)
    a = c.arch
    w = make_weights(a, 11, "cpu")
    model, _ = build_model(a, w, "cpu")
    w2p, shift = T.cameras(a, {"pool": 3}, 12)
    f = T.features(a, {"pool": 3}, 12, "cpu")
    args = (f, torch.from_numpy(w2p), torch.from_numpy(shift))
    with torch.no_grad():
        got = model(*args)
        want = Ref(a, w).forward(*args)
    for key, ref in want.items():
        assert spread_error(got[key], ref) < 1e-5, key


def test_full_cell_correct():
    out = tiny.run("ver36-full-b8")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["volumes_per_s"]["value"] > 0


def test_train_step_matches_port():
    out = tiny.run("vocc-train-b1")
    assert out["correct"], out["checks"]
    # fp32 on both sides, the same dropout draws and matches
    assert out["checks"]["loss"]["value"] < 1e-5
    assert out["checks"]["first_grad"]["value"] < 1e-4
    assert out["checks"]["first_grad_q25"]["value"] < 1e-4
    assert out["checks"]["change"]["value"] < 1e-4


def test_first_grad_quartile_reads_broad_gaps_not_local_ones():
    from verbench.drivers.train_step import leaf_quartile
    want = {f"leaf{i}": torch.linspace(1.0, 2.0, 10) for i in range(8)}
    # a kink moves the leaves upstream of one location, not the rest
    local = {k: v * (1.05 if i < 5 else 1.0)
             for i, (k, v) in enumerate(want.items())}
    broad = {k: v * 1.001 for k, v in want.items()}
    assert leaf_quartile(local, want, 0.0) == 0.0
    assert abs(leaf_quartile(broad, want, 0.0) - 1e-3) < 1e-6


def test_dump_layout_matches_reference():
    out = tiny.run("ver36-dump-b8", dtype="float32")
    assert out["correct"], out["checks"]
    assert out["checks"]["volume"]["value"] < 1e-5
    assert out["metrics"]["dump_volumes_per_s"]["value"] > 0


def test_auction_matches_exact_assignment_on_clear_costs():
    from verbench.reference.train import auction, hungarian
    rng = np.random.default_rng(0)
    cost = rng.uniform(0, 10, (12, 4)).astype(np.float32)
    assert auction(cost) == hungarian(torch.from_numpy(cost))
