"""The yardstick's FLOP formulas against ``FlopCounterMode`` over the
plain reference at a small size, and the published upsampler counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from verbench import flops
from verbench.bench import Cell
from verbench import traffic as T
from verbench.reference.arch import make_weights
from verbench.reference.model import Ref

from . import tiny


@pytest.mark.parametrize("workload", ["ver36-full-b8", "vocc-train-b1"])
def test_forward_flop_matches_counter(workload):
    """The dense count (what the reference computes) equals the counter's
    matrix products, plus the deformable taps from shapes; the counter
    also sees the 4 x 4 camera projection, which the formulas leave out."""
    c = tiny.cell(workload, dtype="float32")
    a = c.arch
    w = make_weights(a, 1, "cpu")
    w2p, shift = T.cameras(a, {"pool": 1}, 2)
    f = T.features(a, {"pool": 1}, 2, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        Ref(a, w).forward(f, torch.from_numpy(w2p), torch.from_numpy(shift))
    projection = 2 * a.num_cams * a.bev_num * 4 * 4
    taps = flops.lift_tap_flop(a, needed=False) + flops.decoder_tap_flop(a)
    assert fc.get_total_flops() + taps - projection == flops.forward_flop(
        a, needed=False)


def test_upsampler_flop_at_vocc_width():
    fact, dense = flops.upsampler_flop(768, 4, 15, 15, 3)
    assert round(fact / 1e9, 1) == 318.5     # chip_smoke.upsampler_flop
    assert round(dense / 1e9, 1) == 1672.2


def test_needed_counts_the_factorisation_and_capacity():
    c = tiny.cell("ver36-full-b8")
    a = c.arch
    assert flops.lift_tap_flop(a) * a.bev_num == \
        flops.lift_tap_flop(a, needed=False) * a.sca_query_capacity
    assert flops.forward_flop(a) < flops.forward_flop(a, needed=False)
    assert flops.train_flop(a) == 3 * flops.forward_flop(a)


def test_deform_bytes_at_the_headline():
    a = Cell(tiny.ROOT, "ver36-full-b8").arch
    # bf16 value and output, fp32 locations and weights, 192 slots
    assert flops.deform_bytes(a, 8) == 214_106_112
    least = flops.deform_least_s(a, 8, valid_taps=0)
    assert least == pytest.approx(214_106_112 / 3.35e12)
