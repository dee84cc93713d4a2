"""The upsampler's assembly kernel (``vln_ver_tpu_torch/ops/up_assemble.py``,
``csrc/up_assemble.cu``) and the upsampler's route to it.

On the CPU: which calls the route gives the kernel (autograd off on the
card, bf16 or fp32 stages, channels a multiple of 8) and which keep the
stack-and-add path; the ``up#calls`` and ``up#fused_calls`` counters; the
plain assembly against a cell-by-cell sum of the taps that feed each cell
(every parity phase at its window offset, the k = 0 and k = 2 taps only
where their planes exist, the profile broadcast over planes and batch);
the wrapper's refusals.  On the card (marked ``gpu``; each skips in the
fixture where there is none): the kernel against the plain assembly bit for
bit at the 36-view widths (768 channels, 15 x 15 to 60 x 60 in three
stages), batch 1 and 8, bf16 and fp32, Z = 4 and 3; the z-major route's
even grid against the stack-and-add path's; the wrapper's refusals; a full
bf16 eval forward whose every upsampler call takes the kernel and never
pads, against the same model with the route forced off.

This file imports neither JAX nor the JAX package, so its card tests run
on a host that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_up_assemble.py
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from chip_smoke import up_assemble_stages
from test_torch_gpu import TINY, _viewpoints
from vln_ver_tpu_torch.models import build_model
from vln_ver_tpu_torch.models import head as head_module
from vln_ver_tpu_torch.models.head import OccUpsampler
from vln_ver_tpu_torch.ops import up_assemble
from vln_ver_tpu_torch.ops.up_assemble import (KERNEL, Taps, assemble,
                                               assemble_plain, route)
from vln_ver_tpu_torch.runtime import fp32_precision
from vln_ver_tpu_torch.utils import profiling as tprof

BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _upsampler(channels, stages, dtype, seed=0, device="cpu"):
    """Random weights, biases drawn away from zero (so the profile shows)."""
    up = OccUpsampler(channels, stages, dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for stage in up:
            stage.reset_parameters(g)
            stage.bias.normal_(0.0, 0.5, generator=g)
    return up.to(device)


# -- the CPU ---------------------------------------------------------------

ROUTES = {   # (device, channels, dtype, grad) -> kernel
    "inference_on_the_card_bf16": (("cuda", 768, BF16, False), True),
    "inference_on_the_card_fp32": (("cuda", 768, torch.float32, False),
                                   True),
    "eight_channels": (("cuda", 8, BF16, False), True),
    "grad": (("cuda", 768, BF16, True), False),
    "cpu": (("cpu", 768, BF16, False), False),
    "fp16": (("cuda", 768, torch.float16, False), False),
    "channels_not_a_multiple_of_8": (("cuda", 12, BF16, False), False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route(case):
    (device, channels, dtype, grad), fused = ROUTES[case]
    ctx = torch.enable_grad if grad else torch.inference_mode
    with ctx():
        assert route(torch.device(device), channels, dtype) is fused


@pytest.mark.parametrize("fused", [False, True], ids=["stack", "fused"])
def test_counters(monkeypatch, fused):
    """``up#calls`` counts every upsampler call, ``up#fused_calls`` those
    the kernel's route served (forced here: the CPU takes the plain
    assembly behind it), informative or full."""
    up = _upsampler(16, 2, torch.float32)
    if fused:
        monkeypatch.setattr(up_assemble, "route", lambda *a: True)
    x = torch.randn(2, 3, 3, 4, 16)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            up.informative(x)
        up(x)
    counters = tprof.recorded()["counters"]
    assert counters["up#calls"] == 3.0
    assert counters.get("up#fused_calls") == (3.0 if fused else None)


def _taps(z, b, h, w, c, gen, planes=None):
    """Taps of random values; with ``planes``, a profile (one plane and
    one batch standing for ``planes``)."""
    def t(n, bb):
        return torch.randn(n, bb, h, w, c, generator=gen)
    if planes is not None:
        return Taps(t(1, 1), *((t(1, 1), t(1, 1)) if planes > 2
                               else (None, None)))
    return Taps(t(z, b), *((t(z - 2, b), t(z - 2, b)) if z > 2
                           else (None, None)))


def _cell_by_cell(phases, prof, grid, z, b, m_y, m_x, c):
    """Each even cell's sum, one cell at a time, as the kernel's note
    states it."""
    out = torch.empty(z, b, grid * m_y, grid * m_x, c)
    for zi in range(z):
        for bi in range(b):
            for y in range(grid * m_y):
                for x in range(grid * m_x):
                    py, px = (y % 2, x % 2) if grid == 2 else (0, 0)
                    t = phases[2 * py + px] if grid == 2 else phases[0]
                    cell = (bi, y // grid + py, x // grid + px)
                    v = t.mid[(zi, *cell)].clone()
                    if t.low is not None and zi >= 2:
                        v += t.low[(zi - 2, *cell)]
                    if t.high is not None and zi <= z - 3:
                        v += t.high[(zi, *cell)]
                    if prof is not None:
                        p = prof.mid[0, 0, y, x].clone()
                        if prof.low is not None and zi >= 2:
                            p += prof.low[0, 0, y, x]
                        if prof.high is not None and zi <= z - 3:
                            p += prof.high[0, 0, y, x]
                        v += p
                    out[zi, bi, y, x] = v
    return out


@pytest.mark.parametrize("grid, with_prof", [(1, False), (2, True),
                                             (2, False)])
@pytest.mark.parametrize("z", [1, 2, 3, 4])
def test_plain_assembly_is_the_cell_by_cell_sum(z, grid, with_prof):
    b, m_y, m_x, c = 2, 2, 3, 8
    gen = torch.Generator().manual_seed(z)
    phases = [_taps(z, b, m_y + oy, m_x + ox, c, gen)
              for oy, ox in ([(0, 0), (0, 1), (1, 0), (1, 1)] if grid == 2
                             else [(0, 0)])]
    prof = (_taps(1, 1, grid * m_y, grid * m_x, c, gen, planes=z)
            if with_prof else None)
    got = assemble(phases, prof, grid)
    assert got.shape == (z, b, grid * m_y, grid * m_x, c)
    torch.testing.assert_close(
        got, _cell_by_cell(phases, prof, grid, z, b, m_y, m_x, c),
        rtol=1e-6, atol=1e-6)


def test_plain_assembly_rounds_once():
    """bf16 taps summed in fp32 and rounded once: at plane 2 of five,
    1 + 2^-8 + 2^-8 is 1 + 2^-7, exact in bf16, where a bf16 add after
    each tap would round 1 + 2^-8 to 1 twice; at plane 0 (one tap beside
    the middle one) 1 + 2^-8 rounds to 1."""
    mid = torch.ones(5, 1, 1, 1, 8, dtype=BF16)
    half_ulp = torch.full((3, 1, 1, 1, 8), 2.0 ** -8, dtype=BF16)
    got = assemble_plain([Taps(mid, half_ulp, half_ulp)], None, 1)
    assert float(got[2, 0, 0, 0, 0]) == 1.0 + 2.0 ** -7
    assert float(got[0, 0, 0, 0, 0]) == 1.0


def test_plain_assembly_and_the_wrapper_refuse_what_they_do_not_take():
    gen = torch.Generator().manual_seed(0)
    one = [_taps(4, 1, 2, 2, 8, gen)]
    with pytest.raises(ValueError, match="on the card"):
        KERNEL(one, None, 1)
    with pytest.raises(ValueError, match="4 on grid 2"):
        assemble(one, None, 2)
    with pytest.raises(ValueError, match="phase taps"):
        assemble([one[0]] * 4, None, 2)
    with pytest.raises(ValueError, match="k = 0 and k = 2"):
        assemble([Taps(one[0].mid, None, None)], None, 1)


# -- the card --------------------------------------------------------------

# the 36-view headline's upsampler: 768 channels, 15 x 15 -> 60 x 60 even
# cells in three stages
VER36 = dict(channels=768, stages=3, hw=15)


@pytest.mark.gpu
@pytest.mark.parametrize("z", [4, 3])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", [BF16, torch.float32],
                         ids=["bf16", "fp32"])
def test_kernel_matches_the_plain_assembly(cuda, dtype, batch, z):
    """Every stage's kernel output bit for bit the plain assembly's, on the
    stage's own convolution outputs (the three phases of asymmetric
    padding read at their offsets, Z = 3's one k = 0 and k = 2 plane),
    by chip_smoke.py phase 5d's check."""
    c, hw = VER36["channels"], VER36["hw"]
    up = _upsampler(c, VER36["stages"], dtype, device=cuda)
    x = torch.randn(batch, z, hw, hw, c, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    stages = up_assemble_stages(up, x)
    assert [(s["launches"], s["equal"], s["shape"], s["dtype"])
            for s in stages] == [
        (1, True, (z, batch, hw * 2 ** i, hw * 2 ** i, c), dtype)
        for i in range(VER36["stages"])]
    torch.cuda.empty_cache()


def _rel(got, ref):
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, limit", [(BF16, 2e-2), (torch.float32,
                                                         1e-5)],
                         ids=["bf16", "fp32"])
def test_fused_route_matches_the_stack_path(cuda, monkeypatch, dtype, limit):
    """The z-major route on the card (one kernel a stage) against the
    stack-and-add path on the same parameters, at the 36-view widths,
    batch 2: the same even grid within the stack path's own bf16
    roundings (phase 5b's limit), and in fp32 (TF32 off) within the
    convolutions' order of sums."""
    c, hw = VER36["channels"], VER36["hw"]
    up = _upsampler(c, VER36["stages"], dtype, device=cuda)
    x = torch.randn(2, 4, hw, hw, c, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    with torch.inference_mode(), fp32_precision(dtype):
        before = KERNEL.launches
        got, bias = up.informative(x)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + VER36["stages"]
        monkeypatch.setattr(up_assemble, "route", lambda *a: False)
        want, _ = up.informative(x)
    assert got.shape == want.shape and bias is up[-1].bias
    assert _rel(got, want) <= limit


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    t = torch.randn(4, 1, 3, 3, 16, device=cuda, generator=gen)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        KERNEL([Taps(t.half(), t[:2].half(), t[2:].half())], None, 1)
    with pytest.raises(ValueError, match="contiguous"):
        u = t.transpose(2, 4).contiguous().transpose(2, 4)
        KERNEL([Taps(u, u[:2], u[2:])], None, 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        u = torch.randn(4, 1, 3, 3, 17, device=cuda, generator=gen)[..., 1:]
        KERNEL([Taps(u, u[:2], u[2:])], None, 1)
    with pytest.raises(ValueError, match="share their strides"):
        KERNEL([Taps(t, t[:2].transpose(2, 3), t[2:])], None, 1)
    phases = [Taps(*(torch.randn(n, 1, 3 + oy, 3 + ox, 16, device=cuda,
                                 generator=gen) for n in (4, 2, 2)))
              for oy in (0, 1) for ox in (0, 1)]
    with pytest.raises(ValueError, match="profile"):
        KERNEL(phases, Taps(t[:1], t[:1], t[:1]), 2)


# TINY in bf16 with three planes (the k = 0 and k = 2 taps run): an even
# grid of 10 x 10 from 5 x 5 in two stages
CFG = dataclasses.replace(TINY, dtype=BF16, bev_z=3)


def _rms(t):
    return float(t.double().pow(2).mean().sqrt())


def _refuse(*args, **kwargs):
    raise AssertionError("the stack-and-add path ran")


@pytest.mark.gpu
def test_eval_forward_takes_the_kernel(cuda, monkeypatch):
    """A bf16 eval forward on the card: every upsampler call takes the
    kernel (``up#fused_calls`` equals ``up#calls``), a launch a stage, no
    ``F.pad`` and no stack-and-add stage method; its occupancy against
    the same model with the route forced off, within the stack path's
    bf16 roundings carried through occ_proj and the MLP."""
    model = build_model(CFG, cuda, seed=0)
    args = [torch.from_numpy(a).to(cuda) for a in _viewpoints(2, CFG)]
    stages = len(model.pts_bbox_head.up_sample)
    with torch.inference_mode():
        with monkeypatch.context() as m:
            m.setattr(F, "pad", _refuse)
            m.setattr(head_module._UpStage, "even_conv", _refuse)
            m.setattr(head_module._UpStage, "phase_conv", _refuse)
            before = KERNEL.launches
            with profile(activities=[ProfilerActivity.CPU]):
                got = model(*args)
                torch.cuda.synchronize()
            counters = tprof.recorded()["counters"]
        assert KERNEL.launches == before + stages
        assert counters["up#calls"] == counters["up#fused_calls"] == 1.0
        monkeypatch.setattr(up_assemble, "route", lambda *a: False)
        ref = model(*args)
    assert torch.equal(got["bev_embed"], ref["bev_embed"])
    occ, want = got["occupancy_preds"], ref["occupancy_preds"]
    assert occ.shape == want.shape and occ.dtype == want.dtype
    assert float((occ - want).abs().max()) <= 2 ** -3 * float(
        want.abs().max())
    assert _rms(occ - want) <= 2 ** -6 * _rms(want)
