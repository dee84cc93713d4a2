"""The occupancy MLP kernel (``vln_ver_tpu_torch/ops/occ_mlp.py``,
``csrc/occ_mlp.cu``) and the head's route to it.

On the CPU: which calls the route gives the kernel (inference on the card
with a bf16 ``occ_proj``, the ``'zhwc'`` layout and a branch the kernel
takes) and which keep the eager chain; the ``occ#calls`` and
``occ#fused_calls`` counters; the head's eager output, and the fused
path's plumbing run through the plain version; the wrapper's refusals
and the launch grid.  On the card (marked ``gpu``; each skips in the
fixture where there is none): the kernel against the eager branch and
interleave at the 36-view shape (batch 8 and 1), at a row count that is
not a multiple of the tile, with 16 and 17 classes; the odd cells bit for
bit; the wrapper's refusals; a full bf16 forward against the same model
with the route forced eager.

This file imports neither JAX nor the JAX package, so its card tests run
on a host that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_occ_mlp.py
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_gpu import TINY, _viewpoints
from vln_ver_tpu_torch.models import build_model
from vln_ver_tpu_torch.models import head as head_module
from vln_ver_tpu_torch.models.head import ClsBranch
from chip_smoke import branch_float64
from vln_ver_tpu_torch.ops.occ_mlp import (KERNEL, branch_params,
                                           fused_route, lattice_plain,
                                           occ_mlp_lattice, occ_mlp_rows,
                                           plan_grid, takes)
from vln_ver_tpu_torch.utils import profiling as tprof

BF16 = torch.bfloat16
# TINY in bf16 with an occupancy branch the kernel takes (occ 7 x 20 x 20,
# so a 10 x 10 even grid; bev_z 2 against occ_z 7: the z-fused occ_proj)
CFG = dataclasses.replace(TINY, dtype=BF16, occ_dims=16)
# the z-preserving occ_proj: occ_z = bev_z = 2
CFG_Z = dataclasses.replace(CFG, occupancy_size=(0.6, 0.6, 1.75))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@torch.no_grad()
def _perturb(branch, seed):
    """Biases and LayerNorm affines away from their zero / one init, so
    that each term of the kernel's arithmetic shows."""
    g = torch.Generator().manual_seed(seed)
    for i in (0, 3, len(branch) - 1):
        branch[i].bias.copy_(torch.randn(branch[i].bias.shape, generator=g)
                             * 0.1)
    for i in (1, 4):
        branch[i].weight.copy_(1 + 0.2 * torch.randn(
            branch[i].weight.shape, generator=g))
        branch[i].bias.copy_(0.2 * torch.randn(branch[i].bias.shape,
                                               generator=g))


def _branch(dims, classes, seed, device):
    branch = ClsBranch(dims, classes, 2, BF16)
    g = torch.Generator().manual_seed(seed)
    for i in (0, 3, 6):
        branch[i].reset_parameters(g)
    _perturb(branch, seed)
    return branch.to(device).eval()


def _head(cfg=CFG, seed=0, device="cpu"):
    model = build_model(cfg, "cpu", seed)
    head = model.pts_bbox_head
    _perturb(head.occ_branches, seed)
    with torch.no_grad():
        head.up_sample[-1].bias.normal_(
            generator=torch.Generator().manual_seed(seed + 1))
    return model.to(device), head


def _even(head, batch=2, seed=0, device="cpu"):
    """The upsampler's even grid (B, Z, occ_y / 2, occ_x / 2, C) and its
    last bias, as ``OccUpsampler.informative`` gives them."""
    cfg = head.cfg
    g = torch.Generator().manual_seed(seed)
    e = torch.randn(batch, cfg.bev_z, cfg.occ_ydim // 2, cfg.occ_xdim // 2,
                    cfg.embed_dims, generator=g).to(device, cfg.dtype)
    return e, head.up_sample[-1].bias


# -- the CPU ---------------------------------------------------------------

ROUTES = {
    "inference_on_the_card": ({}, True),
    "grad": (dict(grad=True), False),
    "fp32": (dict(proj_dtype=torch.float32), False),
    "cpu": (dict(device="cpu"), False),
    "training": (dict(training=True), False),
    "zhwc_dense": (dict(cfg=dict(occ_layout="zhwc_dense")), False),
    "ref": (dict(cfg=dict(occ_layout="ref")), False),
    "one_hidden_layer": (dict(cfg=dict(num_occ_fcs=1)), False),
    "dims_not_a_multiple_of_16": (dict(cfg=dict(occ_dims=24)), False),
    "dims_over_128": (dict(cfg=dict(occ_dims=144)), False),
    "classes_over_32": (dict(cfg=dict(occupancy_classes=33)), False),
    "widest": (dict(cfg=dict(occ_dims=128, occupancy_classes=32)), True),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route(case):
    kw, fused = ROUTES[case]
    cfg = dataclasses.replace(CFG, **kw.get("cfg", {}))
    ctx = torch.enable_grad if kw.get("grad") else torch.inference_mode
    with ctx():
        assert fused_route(cfg, torch.device(kw.get("device", "cuda")),
                           kw.get("proj_dtype", BF16),
                           kw.get("training", False)) is fused


@pytest.mark.parametrize("dims, classes, fcs, ok", [
    (128, 16, 2, True), (16, 1, 2, True), (128, 17, 2, True),
    (128, 16, 3, False), (8, 4, 2, False), (256, 16, 2, False),
    (128, 0, 2, False)])
def test_takes(dims, classes, fcs, ok):
    assert takes(fcs, dims, classes) is ok


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_counters(monkeypatch, fused):
    """``occ#calls`` counts every even-cell call, ``occ#fused_calls`` those
    the kernel's route served (forced here: the CPU takes the plain
    version behind it)."""
    _, head = _head()
    if fused:
        monkeypatch.setattr(head_module, "fused_route", lambda *a: True)
    e, bias = _even(head)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            head._bias_aware_logits(e, bias)
    counters = tprof.recorded()["counters"]
    assert counters["occ#calls"] == 3.0
    assert counters.get("occ#fused_calls") == (3.0 if fused else None)


@pytest.mark.parametrize("cfg", [
    CFG, dataclasses.replace(CFG, dtype=torch.float32), CFG_Z],
    ids=["bf16", "fp32", "z_kept"])
def test_cpu_output_is_the_eager_path(cfg):
    """On the CPU the head keeps its eager chain, under inference and with
    autograd on: the branch module on occ_proj's rows and the bias cell's,
    interleaved by the plain lattice."""
    _, head = _head(cfg)
    e, bias = _even(head)
    for ctx in (torch.inference_mode, torch.enable_grad):
        with ctx():
            got = head._bias_aware_logits(e, bias)
            b = bias.to(e.dtype)
            bias_rows = head._occ_proj_rows(b.expand(
                1, cfg.bev_z, 1, 1, cfg.embed_dims))
            ref = lattice_plain(head._occ_proj_rows(e + b), head.occ_branches,
                                head.occ_branches(bias_rows).reshape(
                                    cfg.occ_zdim, -1))
        assert got.shape == (2, cfg.occ_zdim, cfg.occ_ydim, cfg.occ_xdim,
                             cfg.occupancy_classes)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("cfg", [CFG, CFG_Z], ids=["z_fused", "z_kept"])
def test_fused_plumbing_through_the_plain_version(monkeypatch, cfg):
    """The fused path's rows, bias rows and lattice, run through the plain
    version on the CPU, give the eager path's logits bit for bit: the
    kernel gets the eager chain's inputs in the layout it reads."""
    _, head = _head(cfg)
    e, bias = _even(head)
    with torch.inference_mode():
        ref = head._bias_aware_logits(e, bias)
        monkeypatch.setattr(head_module, "fused_route", lambda *a: True)
        got = head._bias_aware_logits(e, bias)
    assert torch.equal(got, ref)


def test_plain_lattice_puts_the_bias_logits_at_every_odd_cell():
    branch = _branch(16, 5, 0, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 4, 6, 16, generator=g).to(BF16)
    bias_logits = torch.randn(6, 5, generator=g)
    with torch.inference_mode():
        full = occ_mlp_lattice(x, branch, bias_logits)
        rows = occ_mlp_rows(x, branch)
    assert full.shape == (2, 6, 6, 8, 5)
    assert torch.equal(full[:, :, ::2, ::2], rows.permute(0, 3, 1, 2, 4))
    for dy, dx in ((0, 1), (1, 0), (1, 1)):
        odd = full[:, :, dy::2, dx::2]
        assert torch.equal(odd, bias_logits[None, :, None, None].expand_as(
            odd))
    assert torch.equal(lattice_plain(x, branch, bias_logits), full)


def test_kernel_refuses_cpu_tensors_and_other_branches():
    branch = ClsBranch(16, 5, 2, BF16)
    x = torch.zeros(4, 16, dtype=BF16)
    with pytest.raises(ValueError, match="on the card"):
        KERNEL.rows(x, branch_params(branch))
    with pytest.raises(ValueError, match="on the card"):
        KERNEL.lattice(x.reshape(1, 1, 1, 4, 16), branch_params(branch),
                       torch.zeros(4, 5))
    with pytest.raises(ValueError, match="two hidden layers"):
        branch_params(ClsBranch(16, 5, 1, BF16))


@pytest.mark.parametrize("rows, sms, blocks", [
    (1_008_000, 132, 132), (35, 132, 1), (420, 132, 2), (192, 132, 1),
    (193, 132, 1), (256, 132, 1), (257, 132, 2), (1, 1, 1)])
def test_plan_grid(rows, sms, blocks):
    assert plan_grid(rows, sms) == blocks


# -- the card --------------------------------------------------------------

def _rms(t):
    return float(t.double().pow(2).mean().sqrt())


def _within_eager_rounding(got, eager, exact):
    """The kernel keeps the eager chain's rounding points and differs from
    it only in the order of its fp32 sums, which moves a bf16 rounding now
    and then: its error against the float64 chain is the eager chain's,
    and it stays within the eager chain's own largest error of it."""
    err_eager = (eager.double() - exact).abs()
    assert float((got.double() - eager.double()).abs().max()) <= float(
        err_eager.max())
    assert _rms(got.double() - exact) <= 1.05 * _rms(err_eager)


SHAPES = {   # (batch, h2, w2, occ_z, D, n)
    "ver36_b8": (8, 60, 60, 35, 128, 16),
    "ver36_b1": (1, 60, 60, 35, 128, 16),
    "ragged_b3": (3, 2, 2, 35, 128, 16),
    "ragged_b3_n17": (3, 2, 2, 35, 128, 17),
    "ver36_b1_n17": (1, 60, 60, 35, 128, 17),
    "d16": (2, 10, 10, 7, 16, 4),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_the_eager_chain(cuda, shape):
    b, h2, w2, oz, d, n = SHAPES[shape]
    branch = _branch(d, n, 3, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (0.7 * torch.randn(b, h2, w2, oz, d, generator=g,
                           device=cuda)).to(BF16)
    bias_rows = (0.7 * torch.randn(oz, d, generator=g, device=cuda)).to(BF16)
    with torch.inference_mode():
        before = KERNEL.launches
        bias_logits = occ_mlp_rows(bias_rows, branch)
        got = occ_mlp_lattice(x, branch, bias_logits)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 2
        assert got.shape == (b, oz, 2 * h2, 2 * w2, n)
        assert got.dtype == torch.float32
        for dy, dx in ((0, 1), (1, 0), (1, 1)):
            odd = got[:, :, dy::2, dx::2]
            assert torch.equal(odd, bias_logits[None, :, None, None]
                               .expand_as(odd))
        _within_eager_rounding(bias_logits, branch(bias_rows),
                               branch_float64(branch, bias_rows))
        even = got[:, :, ::2, ::2].permute(0, 2, 3, 1, 4)
        for i in range(b):     # a batch at a time: the float64 chain
            _within_eager_rounding(even[i], branch(x[i]),
                                   branch_float64(branch, x[i]))


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    branch = _branch(128, 16, 0, cuda)
    x = torch.zeros(2, 4, 4, 35, 128, device=cuda, dtype=BF16)
    bias_logits = torch.zeros(35, 16, device=cuda)
    prm = branch_params(branch)
    with pytest.raises(TypeError, match="bfloat16"):
        KERNEL.lattice(x.float(), prm, bias_logits)
    with pytest.raises(ValueError, match="contiguous"):
        KERNEL.lattice(x.transpose(1, 2), prm, bias_logits)
    with pytest.raises(ValueError, match="on the card"):
        KERNEL.lattice(x.cpu(), prm, bias_logits)
    with pytest.raises(ValueError, match="bias_logits"):
        KERNEL.lattice(x, prm, bias_logits[:34])
    with pytest.raises(ValueError, match="multiple of 16"):
        KERNEL.rows(x[..., :120].contiguous(),
                    branch_params(_branch(120, 16, 0, cuda)))


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [CFG, CFG_Z], ids=["z_fused", "z_kept"])
def test_full_forward_matches_the_eager_route(cuda, monkeypatch, cfg):
    """A full bf16 forward on the card through the kernel gives the
    occupancy of the same model with the route forced eager, within the
    eager chain's rounding; everything upstream is the same."""
    model, head = _head(cfg, device=cuda)
    args = [torch.from_numpy(a).to(cuda) for a in _viewpoints(2, cfg)]
    with torch.inference_mode():
        before = KERNEL.launches
        got = model(*args)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 2
        monkeypatch.setattr(head_module, "fused_route", lambda *a: False)
        ref = model(*args)
    assert torch.equal(got["bev_embed"], ref["bev_embed"])
    occ, want = got["occupancy_preds"], ref["occupancy_preds"]
    assert occ.shape == want.shape and occ.dtype == want.dtype
    scale = float(want.abs().max())
    torch.testing.assert_close(occ, want, rtol=0, atol=2 ** -6 * scale)
    assert _rms(occ - want) <= 2 ** -9 * _rms(want)
