"""The control, the plain reference computed in the nearest precision
below the configuration's, in the program's place, comes out not
correct against the cells' limits: at a tiny size on the CPU (fp8 for
the bf16 cells), and at the cells' own sizes on the card (``gpu``: fp8
and TF32 on three seeds each, as the limits were set)."""

import pytest
import torch

from verbench import calibrate
from verbench.bench import Cell
from verbench.compare import control_precision

from . import tiny


@pytest.mark.parametrize("workload", ["ver36-full-b8", "ver36-dump-b8"])
def test_fp8_control_fails_at_tiny_size(workload):
    cell = tiny.cell(workload)
    out = calibrate.readings(cell, 5, 0.3, control="fp8", device="cpu")
    limits = cell.limits
    assert any(v > limits[k] for k, v in out["numbers"].items()), out


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ver36-full-b8", "ver36-dump-b8",
                                      "vocc-train-b1"])
def test_control_fails_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = Cell(tiny.ROOT, workload)
    control = control_precision(cell.arch.dtype)
    for seed in (401, 402, 403):
        out = calibrate.readings(cell, seed, 1.0, control=control)
        assert any(v > cell.limits[k] for k, v in out["numbers"].items()), out
