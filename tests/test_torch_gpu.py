"""The CUDA deformable-attention kernel against its plain version, and the
port's VER dump, full forward and eval path on the card against the CPU.
Marked ``gpu``; each test skips where there is no card (decided in the
fixture, never at import, so every worker collects the same tests).

This file imports neither JAX nor the JAX package, so it also runs on a
host that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from vln_ver_tpu_torch.models import VERConfig, build_model
from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel
from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d
from vln_ver_tpu_torch.ops.deform_cuda import (KERNEL, KERNEL_BWD,
                                              ms_deform_attn_2d_fused)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(device, dtype=torch.float32, seed=0, bs=4, heads=4, dim=16, nq=57,
          pts=8, h=14, w=14, lo=-0.1, hi=1.1):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal(
        (bs, h * w, heads, dim)).astype(np.float32)).to(device, dtype)
    locs = torch.from_numpy(rng.uniform(
        lo, hi, (bs, nq, heads, 1, pts, 2)).astype(np.float32)).to(device)
    wsm = torch.from_numpy(rng.standard_normal(
        (bs, nq, heads, 1, pts)).astype(np.float32)).to(device).softmax(-1)
    return v, locs, wsm.contiguous()


@pytest.mark.parametrize("shape", [
    dict(h=14, w=14, nq=57), dict(h=6, w=6, nq=57), dict(h=10, w=20, nq=57),
    dict(h=14, w=14, nq=900, bs=6, heads=8, dim=96),
    dict(h=14, w=14, nq=65, dim=40, pts=37),        # ragged d and P > 32
    dict(h=5, w=7, nq=3, lo=-30.0, hi=30.0),        # far out of the map
    dict(h=14, w=14, nq=57, bs=1),                  # fewer items than SMs
    dict(h=14, w=14, nq=901, bs=6, heads=8, dim=96),
    dict(h=14, w=14, nq=900, bs=48, heads=8, dim=96),   # B=8
    dict(h=14, w=14, nq=57, bs=2, heads=2, dim=256),    # one V stage fits
    dict(h=14, w=14, nq=57, dim=3),                 # 12 B rows: no TMA copy
])
def test_kernel_matches_plain_fp32(cuda, shape):
    v, locs, wsm = _case(cuda, **shape)
    hw = ((shape["h"], shape["w"]),)
    with torch.inference_mode():
        before = KERNEL.launches
        got = ms_deform_attn_2d_fused(v, hw, locs, wsm)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 1
        ref = ms_deform_attn_2d(v, hw, locs, wsm)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [
    dict(bs=6, heads=8, dim=96, nq=900), dict(bs=6, heads=8, dim=96, nq=901),
    dict(dim=3),                                    # odd d: padded rows
])
def test_kernel_matches_plain_bf16(cuda, shape):
    v, locs, wsm = _case(cuda, torch.bfloat16, **shape)
    with torch.inference_mode():
        got = ms_deform_attn_2d_fused(v, ((14, 14),), locs, wsm)
        torch.cuda.synchronize()
        ref = ms_deform_attn_2d(v.float(), ((14, 14),), locs, wsm)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=1e-2, atol=1e-2)


def test_kernel_refuses_what_it_does_not_take(cuda):
    v, locs, wsm = _case(cuda)
    hw = ((14, 14),)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            ms_deform_attn_2d_fused(v.transpose(1, 2).contiguous()
                                    .transpose(1, 2), hw, locs, wsm)
        with pytest.raises(TypeError):
            ms_deform_attn_2d_fused(v.half(), hw, locs, wsm)
        with pytest.raises(ValueError, match="rows"):
            ms_deform_attn_2d_fused(v, ((13, 14),), locs, wsm)
        with pytest.raises(ValueError, match="device"):
            ms_deform_attn_2d_fused(v, hw, locs.cpu(), wsm)
        shifted = torch.empty(locs.numel() + 1, device=cuda)[1:]
        with pytest.raises(ValueError, match="aligned"):
            ms_deform_attn_2d_fused(v, hw, shifted.view(locs.shape), wsm)
        with pytest.raises(ValueError, match="shared memory"):
            big = torch.zeros(1, 30 * 30, 4, 96, device=cuda)
            ms_deform_attn_2d_fused(big, ((30, 30),), locs[:1], wsm[:1])
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 32 * 32, 4, 128, device=cuda,
                          dtype=torch.bfloat16)
        g = torch.zeros(1, 57, 512, device=cuda, dtype=torch.bfloat16)
        KERNEL_BWD(big, ((32, 32),), locs[:1], wsm[:1], g)


def _grads(fn, v, locs, wsm, g):
    v, locs, wsm = (t.detach().clone().requires_grad_()
                    for t in (v, locs, wsm))
    out = fn(v, locs, wsm)
    out.backward(g)
    return out, v.grad, locs.grad, wsm.grad


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, dict(h=14, w=14, nq=900, bs=6, heads=8, dim=96)),
    (torch.bfloat16, dict(h=14, w=14, nq=900, bs=6, heads=8, dim=96)),
    (torch.float32, dict(h=5, w=7, nq=57, lo=-30.0, hi=30.0)),  # far out
    (torch.float32, dict(h=14, w=14, nq=57, dim=3)),
    (torch.float32, dict(h=10, w=20, nq=57)),
    (torch.float32, dict(h=14, w=14, nq=65, dim=40, pts=37)),   # P > 32
    (torch.float32, dict(h=14, w=14, nq=900, bs=6, heads=8, dim=256)),
    (torch.float32, dict(h=14, w=14, nq=901, bs=6, heads=8, dim=96)),
    (torch.float32, dict(h=14, w=14, nq=900, bs=1, heads=8, dim=96)),
    (torch.float32, dict(h=14, w=14, nq=900, bs=48, heads=8, dim=96)),  # B=8
    (torch.bfloat16, dict(h=14, w=14, nq=57, dim=3)),   # odd bf16 rows
])
def test_backward_kernel_matches_plain_autograd(cuda, dtype, shape):
    """dvalue, dlocations and dweights of the CUDA backward against
    autograd of the plain version on the same inputs.  fp32: 1e-4 / 1e-5
    on dvalue and dweights, 1e-3 / 1e-4 on dlocations (scaled by W and
    H); bf16: 1e-2."""
    v, locs, wsm = _case(cuda, dtype, **shape)
    hw = ((shape["h"], shape["w"]),)
    g = torch.randn(v.shape[0], locs.shape[1], v.shape[2] * v.shape[3],
                    device=cuda, generator=torch.Generator(cuda).manual_seed(
                        1)).to(dtype)
    before = (KERNEL.launches, KERNEL_BWD.launches)
    out, dv, dl, dw = _grads(
        lambda *a: ms_deform_attn_2d_fused(a[0], hw, a[1], a[2]),
        v, locs, wsm, g)
    torch.cuda.synchronize()
    assert (KERNEL.launches, KERNEL_BWD.launches) == (before[0] + 1,
                                                      before[1] + 1)
    _, rv, rl, rw = _grads(
        lambda *a: ms_deform_attn_2d(a[0].float(), hw, a[1], a[2]),
        v, locs, wsm, g.float())
    assert dv.dtype == dtype and dl.dtype == dw.dtype == torch.float32
    if dtype == torch.float32:
        tol = {"dv": (1e-4, 1e-5), "dl": (1e-3, 1e-4), "dw": (1e-4, 1e-5)}
    else:
        tol = dict.fromkeys(("dv", "dl", "dw"), (1e-2, 1e-2))
    for name, got, ref in (("dv", dv, rv), ("dl", dl, rl), ("dw", dw, rw)):
        rtol, atol = tol[name]
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                                   atol=atol, msg=name)


# the launches of the temporal, decoder_on_bev and BEV-2D paths at full
# width: P = 4 (a step's upper 16 lanes hold no point), d = 32, a 15 x 15
# map, nq = 100 and 225
NEW_PATHS = {
    "decoder_on_bev": dict(bs=2, h=15, w=15, heads=8, dim=96, nq=100, pts=4),
    "bev2d_sca": dict(bs=6, h=14, w=14, heads=8, dim=32, nq=225, pts=8),
    "bev2d_tsa": dict(bs=2, h=15, w=15, heads=8, dim=32, nq=225, pts=4),
    "bev2d_decoder": dict(bs=1, h=15, w=15, heads=8, dim=32, nq=100, pts=4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("path", NEW_PATHS)
def test_kernels_match_plain_at_the_new_paths_shapes(cuda, path, dtype):
    """Forward and backward at each new launch shape against the plain
    version and its autograd (fp32: the forward 1e-4 / 1e-5, dlocations
    1e-3 / 1e-4; bf16: 1e-2)."""
    shape = NEW_PATHS[path]
    test_backward_kernel_matches_plain_autograd(cuda, dtype, shape)
    v, locs, wsm = _case(cuda, dtype, seed=2, **shape)
    hw = ((shape["h"], shape["w"]),)
    with torch.inference_mode():
        got = ms_deform_attn_2d_fused(v, hw, locs, wsm)
        ref = ms_deform_attn_2d(v.float(), hw, locs, wsm)
    tol = (1e-4, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(), ref, rtol=tol[0], atol=tol[1])


# the 36-view headline's launches: 288 slots at batch 8 (inference: the
# forward alone) and 72 at bench_train's batch 2 (both kernels), over the
# dense lift's 900 queries and the sparse lift's 192
HEADLINE = {"B=8 dense": dict(bs=288, nq=900), "B=8 sparse": dict(bs=288,
                                                                  nq=192),
            "B=2 dense": dict(bs=72, nq=900), "B=2 sparse": dict(bs=72,
                                                                 nq=192)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", HEADLINE)
def test_kernels_match_plain_at_the_36_view_shapes(cuda, name, dtype):
    """The forward against the plain version (computed over blocks of 72
    slots: each slot's output is its own) and, at 72 slots, the backward
    against its autograd; the tolerances of the tests above."""
    shape = dict(h=14, w=14, heads=8, dim=96, **HEADLINE[name])
    v, locs, wsm = _case(cuda, dtype, seed=3, **shape)
    hw = ((14, 14),)
    with torch.inference_mode():
        got = ms_deform_attn_2d_fused(v, hw, locs, wsm)
        ref = torch.cat([ms_deform_attn_2d(v[i:i + 72].float(), hw,
                                           locs[i:i + 72], wsm[i:i + 72])
                         for i in range(0, shape["bs"], 72)])
    tol = (1e-4, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(), ref, rtol=tol[0], atol=tol[1])
    del got, ref
    if shape["bs"] == 72:
        test_backward_kernel_matches_plain_autograd(cuda, dtype, shape)


def test_backward_kernel_is_reproducible(cuda):
    """Two launches on the same inputs give bitwise-equal dvalue,
    dlocations and dweights: every sum runs in a fixed order (one warp per
    (query, point); private dV copies added up in order), at batch 1,
    where the value CTAs split each slice over a cluster."""
    v, locs, wsm = _case(cuda, bs=6, heads=8, dim=96, nq=900)
    g = torch.randn(6, 900, 8 * 96, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    a = KERNEL_BWD(v, ((14, 14),), locs, wsm, g)
    b = KERNEL_BWD(v, ((14, 14),), locs, wsm, g)
    torch.cuda.synchronize()
    assert KERNEL_BWD.last_plan.qsplit > 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_backward_kernel_writes_bf16_dvalue_without_a_workspace(cuda):
    """bf16 dvalue comes out of the kernel as it is: the call's peak
    allocation stays below its three outputs plus an fp32 dvalue
    workspace (twice dvalue's bytes), which it no longer takes; the
    caching allocator may hand out a block a little larger than asked."""
    v, locs, wsm = _case(cuda, torch.bfloat16, bs=6, heads=8, dim=96,
                         nq=900)
    g = torch.randn(6, 900, 8 * 96, device=cuda).to(torch.bfloat16)
    KERNEL_BWD(v, ((14, 14),), locs, wsm, g)   # build, load, plan
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dv, dl, dw = KERNEL_BWD(v, ((14, 14),), locs, wsm, g)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in (dv, dl, dw))
    assert dv.dtype == torch.bfloat16
    workspace = dv.numel() * 4
    assert torch.cuda.max_memory_allocated() - base < outputs + workspace


def test_backward_kernel_skips_what_is_not_needed(cuda):
    v, locs, wsm = _case(cuda)
    hw = ((14, 14),)
    g = torch.ones(v.shape[0], locs.shape[1], v.shape[2] * v.shape[3],
                   device=cuda)
    full = KERNEL_BWD(v, hw, locs, wsm, g)
    only_v = KERNEL_BWD(v, hw, locs, wsm, g, need_locations=False,
                        need_weights=False)
    only_w = KERNEL_BWD(v, hw, locs, wsm, g, need_value=False,
                        need_locations=False)
    assert only_v[1] is None and only_v[2] is None and only_w[0] is None
    torch.testing.assert_close(only_v[0], full[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(only_w[2], full[2], rtol=0, atol=0)


TINY = VERConfig(num_cams=3, feat_h=6, feat_w=6, in_channels=64,
                 embed_dims=64, num_heads=4, encoder_layers=2, ffn_dim=128,
                 bev_z=2, bev_h=5, bev_w=5, decoder_layers=2, num_query=12,
                 num_classes=5, occupancy_classes=4, occ_dims=8,
                 occupancy_size=(0.6, 0.6, 0.5))   # occupancy 7 x 20 x 20


def _viewpoints(n, cfg=TINY, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, cfg.num_cams, cfg.feat_h, cfg.feat_w,
                                 cfg.in_channels)).astype(np.float32)
    w2p = np.stack([np.stack([
        make_pinhole_world2pixel(70.0, deg * 360.0 / cfg.num_cams,
                                 (0.1 * b, 0.0, 0.0))
        for deg in range(cfg.num_cams)]) for b in range(n)])
    return feats, w2p, np.zeros((n, 3), np.float32)


class _MemoryH5:
    """Just enough of h5py for ``dump_volumes`` (File(path, mode) over a
    dict of arrays per path), so the test also runs without h5py."""
    files = {}

    class File(dict):
        def __init__(self, path, mode):
            super().__init__()
            self.path = path

        def create_dataset(self, name, data, compression, compression_opts):
            assert compression == "gzip"
            self[name] = np.array(data)

        def close(self):
            _MemoryH5.files[self.path] = dict(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()


def test_pipelined_dump_on_card_matches_cpu(cuda, monkeypatch):
    """The pipelined dump's CUDA branch (upload on the transfer thread,
    copy to pinned memory behind an event) writes what the serial CPU
    dump writes, volume for volume."""
    import sys

    from vln_ver_tpu_torch.ver_writer import dump_volumes
    monkeypatch.setitem(sys.modules, "h5py", _MemoryH5)
    feats, w2p, shift = _viewpoints(7)
    dataset = [dict(features=feats[i], world2pixel=w2p[i],
                    origin_shift=shift[i], token=f"scan000_vp{i:03d}")
               for i in range(7)]
    for name, device, serial in (("cpu", "cpu", True),
                                 ("card", cuda, False)):
        model = build_model(TINY, device)

        @torch.inference_mode()
        def bev_only(f, m, s):
            outs = model(f, m, s, only_bev=True)
            return outs["bev_embed"], outs["sca_overflow"]

        res = dump_volumes(bev_only, dataset, TINY, name, batch_size=3,
                           serial=serial, device=device)
        assert res["written"] == 7
    cpu, card = _MemoryH5.files["cpu"], _MemoryH5.files["card"]
    assert sorted(cpu) == sorted(card) and len(cpu) == 7
    for k in cpu:
        assert card[k].shape == (64, 2, 5, 5) and card[k].dtype == np.float32
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-4, atol=1e-4)


def test_tiny_model_on_card_matches_cpu(cuda):
    cfg = TINY
    feats, w2p, shift = map(torch.from_numpy, _viewpoints(2))
    with torch.inference_mode():
        ref = build_model(cfg, "cpu")(feats, w2p, shift,
                                      only_bev=True)["bev_embed"]
        before = KERNEL.launches
        got = build_model(cfg, cuda)(feats.to(cuda), w2p.to(cuda),
                                     shift.to(cuda), only_bev=True)[
                                         "bev_embed"]
        torch.cuda.synchronize()
    assert KERNEL.launches == before + cfg.encoder_layers
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["zhwc", "zhwc_dense", "ref"])
def test_full_forward_on_card_matches_cpu(cuda, layout):
    import dataclasses
    cfg = dataclasses.replace(TINY, occ_layout=layout, add_layout=True)
    feats, w2p, shift = map(torch.from_numpy, _viewpoints(2))
    with torch.inference_mode():
        ref = build_model(cfg, "cpu")(feats, w2p, shift)
        before = KERNEL.launches
        got = build_model(cfg, cuda)(feats.to(cuda), w2p.to(cuda),
                                     shift.to(cuda))
        torch.cuda.synchronize()
    assert KERNEL.launches == before + cfg.encoder_layers
    assert got["occupancy_preds"].shape == (2, 7 * 20 * 20, 4)
    for k in ("bev_embed", "all_cls_scores", "all_bbox_preds",
              "all_layout_preds", "occupancy_preds"):
        atol = 5e-4 if k == "occupancy_preds" else 1e-4
        torch.testing.assert_close(got[k].cpu(), ref[k], rtol=1e-4,
                                   atol=atol)


def test_eval_on_card_matches_cpu(cuda):
    """The eval loop with its decode and histogram on the card gives the
    CPU's metrics (5 viewpoints at batch 2: a short final batch).  At
    0.02 the threshold lies among the random model's scores, so a voxel
    within rounding of it may decode differently: metrics to 1e-3."""
    from vln_ver_tpu_torch.data import synthetic_samples
    from vln_ver_tpu_torch.evaluation.runner import evaluate_model
    samples = synthetic_samples(
        1, 5, num_cams=TINY.num_cams, feat_hw=TINY.feat_h,
        feat_dim=TINY.in_channels,
        occ_dims=(TINY.occ_zdim, TINY.occ_ydim, TINY.occ_xdim))
    metrics = {}
    for device in ("cpu", cuda):
        model = build_model(TINY, device)
        before = KERNEL.launches
        metrics[str(device)] = evaluate_model(
            model, samples, occ_thresholds=(0.02, 0.25), batch_size=2)
    assert KERNEL.launches == before + 3 * TINY.encoder_layers
    cpu, card = metrics["cpu"], metrics[str(cuda)]
    assert cpu.keys() == card.keys()
    for k in cpu:
        assert card[k] == pytest.approx(cpu[k], rel=1e-3, abs=1e-3), k


def test_fp32_upsampler_on_card_is_not_tf32(cuda, monkeypatch):
    """cuDNN's TF32 flag defaults to True and a library caller need not
    clear it; an fp32 model must not take it.  At vocc.py's width (768
    channels, 75 taps) TF32 misses the CPU's upsampler output by more than
    this tolerance, and fp32 stays well inside it."""
    import dataclasses
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = dataclasses.replace(TINY, in_channels=768, embed_dims=768,
                              num_heads=8, ffn_dim=256)
    feats, w2p, shift = map(torch.from_numpy, _viewpoints(1, cfg))
    up = {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device)
        hook = model.pts_bbox_head.up_sample.register_forward_hook(
            lambda mod, args, out, device=str(device): up.__setitem__(
                device, out.cpu()))
        with torch.inference_mode():
            model(feats.to(device), w2p.to(device), shift.to(device))
        hook.remove()
    torch.testing.assert_close(up[str(cuda)], up["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One ``make_train_step`` on the card against one on the CPU: the same
    weights and batch, dropout off, the host matcher, TF32 flags left on by
    the caller (the step runs in fp32 all the same), the card's ReLUs on the
    CPU step's masks (``utils.params.relu_masks``).  The forward and the
    backward kernel launch once per encoder layer; the losses within rtol
    1e-4, every parameter's gradient within 1e-3 of its L2 norm."""
    import dataclasses

    from vln_ver_tpu_torch.data import synthetic_samples
    from vln_ver_tpu_torch.data.mp3d import collate
    from vln_ver_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_train_step, to_device)
    from vln_ver_tpu_torch.utils.params import grads_by_name, relu_masks
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    # the synthetic scenes label boxes with 17 classes, voxels with 16
    cfg = dataclasses.replace(TINY, dropout_rate=0.0, num_classes=17,
                              occupancy_classes=16)
    batch = collate(synthetic_samples(
        1, 2, num_cams=cfg.num_cams, feat_hw=cfg.feat_h,
        feat_dim=cfg.in_channels,
        occ_dims=(cfg.occ_zdim, cfg.occ_ydim, cfg.occ_xdim)))
    tc = TrainConfig(warmup_steps=1, total_steps=10, matcher="host")
    masks, res = [], {}
    for device in (torch.device("cpu"), cuda):
        model = build_model(cfg, device)
        state = create_train_state(model, tc)
        before = (KERNEL.launches, KERNEL_BWD.launches)
        cpu = device.type == "cpu"
        with relu_masks(model, record=masks if cpu else None,
                        pin=None if cpu else masks):
            m = make_train_step(cfg, tc)(state, to_device(batch, device),
                                         seed=0)
        after = (KERNEL.launches, KERNEL_BWD.launches)
        res[device.type] = ({k: float(v) for k, v in m.items()},
                            {n: g.cpu() for n, g in
                             grads_by_name(model).items()},
                            (after[0] - before[0], after[1] - before[1]))
    (lc, gc, nc), (lg, gg, ng) = res["cpu"], res["cuda"]
    assert nc == (0, 0) and ng == (cfg.encoder_layers, cfg.encoder_layers)
    assert lc.keys() == lg.keys()
    for k in lc:
        assert lg[k] == pytest.approx(lc[k], rel=1e-4, abs=1e-7), k
    for n, g in gc.items():
        diff = float(torch.linalg.vector_norm(gg[n] - g))
        assert diff <= 1e-3 * float(torch.linalg.vector_norm(g)) + 1e-6, n


def _card_step(cfg, batch, device, monkeypatch):
    """One ``make_train_step`` of a seed-0 model on ``device``: (the matched
    query of every GT slot in every match the step made, the losses, every
    parameter's gradient, the forward and backward kernel launches)."""
    from vln_ver_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_train_step, objective,
                                         to_device)
    from vln_ver_tpu_torch.utils.params import grads_by_name
    matches, inner = [], objective._match

    def record(*args, **kw):
        out = inner(*args, **kw)
        matches.append(out.cpu())
        return out

    monkeypatch.setattr(objective, "_match", record)
    model = build_model(cfg, device)
    tc = TrainConfig(warmup_steps=1, total_steps=10, matcher="host")
    state = create_train_state(model, tc)
    before = (KERNEL.launches, KERNEL_BWD.launches)
    m = make_train_step(cfg, tc)(state, to_device(batch, device), seed=0)
    launches = (KERNEL.launches - before[0], KERNEL_BWD.launches - before[1])
    monkeypatch.setattr(objective, "_match", inner)
    return (torch.cat([x.flatten() for x in matches]),
            {k: float(v) for k, v in m.items()},
            {n: g.cpu() for n, g in grads_by_name(model).items()}, launches)


def _train_batch(cfg, n=2):
    from vln_ver_tpu_torch.data import synthetic_samples
    from vln_ver_tpu_torch.data.mp3d import collate
    return collate(synthetic_samples(
        1, n, num_cams=cfg.num_cams, feat_hw=cfg.feat_h,
        feat_dim=cfg.in_channels,
        occ_dims=(cfg.occ_zdim, cfg.occ_ydim, cfg.occ_xdim)))


def test_remat_train_step_on_card_matches_plain_step(cuda, monkeypatch):
    """``remat_encoder``: the forward kernel runs again in the backward, on
    autograd's worker thread, where it encodes its tensor map with no
    context current until its first runtime call.  The step matches the
    one without remat on the same weights and batch, dropout on (the
    replay redraws its masks): the same matched queries, the losses within
    rtol 1e-5, each gradient within 1e-4 of its L2 norm; the forward
    kernel launches twice per encoder layer."""
    import dataclasses
    cfg = dataclasses.replace(TINY, num_classes=17, occupancy_classes=16)
    batch = _train_batch(cfg)
    plain = _card_step(cfg, batch, cuda, monkeypatch)
    remat = _card_step(dataclasses.replace(cfg, remat_encoder=True), batch,
                       cuda, monkeypatch)
    assert plain[3] == (cfg.encoder_layers, cfg.encoder_layers)
    assert remat[3] == (2 * cfg.encoder_layers, cfg.encoder_layers)
    assert torch.equal(plain[0], remat[0])
    for k in plain[1]:
        assert remat[1][k] == pytest.approx(plain[1][k], rel=1e-5,
                                            abs=1e-7), k
    for n, g in plain[2].items():
        diff = float(torch.linalg.vector_norm(remat[2][n] - g))
        assert diff <= 1e-4 * float(torch.linalg.vector_norm(g)) + 1e-7, n


def test_sparse_lift_on_card_matches_dense_and_cpu(cuda):
    """The capacity path on the card: the kernel at nq = K on (B * cams)
    rows, the gather and the scatter; equal to the card's dense lift and
    to the CPU's sparse lift within 1e-4, with a zero overflow."""
    import dataclasses

    from vln_ver_tpu_torch.geometry import max_visible_queries
    feats, w2p, shift = _viewpoints(2)
    need = max_visible_queries(w2p, shift, TINY.bev_z, TINY.bev_h,
                               TINY.bev_w, TINY.pc_range)
    cfg = dataclasses.replace(TINY, sca_query_capacity=need)
    x = [torch.from_numpy(a) for a in (feats, w2p, shift)]
    with torch.inference_mode():
        dense = build_model(TINY, cuda)(*(t.to(cuda) for t in x),
                                        only_bev=True)
        before = KERNEL.launches
        got = build_model(cfg, cuda)(*(t.to(cuda) for t in x),
                                     only_bev=True)
        torch.cuda.synchronize()
        launches = KERNEL.launches - before
        cpu = build_model(cfg, "cpu")(*x, only_bev=True)
    assert launches == cfg.encoder_layers and KERNEL.last_nq == need
    assert int(got["sca_overflow"]) == 0
    torch.testing.assert_close(got["bev_embed"], dense["bev_embed"],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["bev_embed"].cpu(), cpu["bev_embed"],
                               rtol=1e-4, atol=1e-4)


def test_vit_frontend_on_card_matches_cpu(cuda):
    """The image path's ViT frontend in fp32 on the card (cuDNN's patch
    convolution and cuBLAS's GEMMs held to true fp32) against the CPU,
    through a resize, within 1e-4."""
    from vln_ver_tpu_torch.models.vit import ViT, vit_feature_frontend
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 3, 40, 48, 3)).astype(np.uint8))
    out = {}
    for device in ("cpu", cuda):
        vit = ViT(32, 8, 64, 2, 4, 256).init_weights(
            torch.Generator().manual_seed(0)).to(device).eval()
        with torch.inference_mode():
            out[str(device)] = vit_feature_frontend(vit, imgs.to(device))
    assert out[str(cuda)].shape == (2, 3, 4, 4, 64)
    torch.testing.assert_close(out[str(cuda)].cpu(), out["cpu"], rtol=1e-4,
                               atol=1e-4)


# -- the VLN agent -----------------------------------------------------------

# tools/test_vln.py --synthetic's policy, held against the CPU port with
# the bounds of chip_smoke.py phase 8 (agent/replay.py)
AGENT_KW = dict(embed_dims=64, num_heads=4, fusion_layers=2, text_layers=2,
                ffn_dim=128, vocab_size=128, max_text_len=16, max_nodes=16,
                bev_z=2, bev_h=4, bev_w=4, num_query_tokens=4)


def _agent_policies(device, grounding=False):
    from vln_ver_tpu_torch.agent.policy import PolicyConfig, build_policy
    from vln_ver_tpu_torch.runtime import set_fp32_precision
    cfg = PolicyConfig(**AGENT_KW)
    set_fp32_precision(cfg.dtype)
    return cfg, (build_policy(cfg, device, seed=2, grounding=grounding),
                 build_policy(cfg, "cpu", seed=2, grounding=grounding))


def test_agent_policy_step_on_card_matches_cpu(cuda):
    from vln_ver_tpu_torch.agent.memory import memory_from_arrays
    from vln_ver_tpu_torch.agent.replay import ATOL, RTOL, hold_call
    cfg, (card, cpu) = _agent_policies(cuda, grounding=True)
    rng = np.random.default_rng(0)
    b, n, c = 3, cfg.max_nodes, cfg.embed_dims
    tokens = np.zeros((b, cfg.max_text_len), np.int32)
    for i in range(b):
        tokens[i, :5 + 4 * i] = rng.integers(1, cfg.vocab_size, 5 + 4 * i)
    rows = []
    for i in range(b):      # 3, 1 and 0 valid memory slots
        valid = np.arange(n) < (3 >> i)
        rows.append(dict(features=rng.standard_normal((n, c)).astype(
            np.float32) * valid[:, None], positions=rng.standard_normal(
            (n, 3)).astype(np.float32), valid=valid, visited=valid & (
            np.arange(n) % 2 == 0)))
    host = dict(tokens=tokens, volume=rng.standard_normal(
        (b, 32, c)).astype(np.float32), cur_pos=rng.standard_normal(
        (b, 3)).astype(np.float32), cur_slot=np.zeros((b,), np.int32),
        obj_feats=rng.standard_normal((b, 4, c)).astype(np.float32),
        obj_valid=np.array([[1, 1, 0, 0]] * b, bool))
    outs = []
    for policy, dev in ((card, cuda), (cpu, "cpu")):
        t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        with torch.inference_mode():
            outs.append(policy(t["tokens"], t["tokens"] > 0, t["volume"],
                               memory_from_arrays(rows, device=dev),
                               t["cur_pos"], t["cur_slot"],
                               obj_feats=t["obj_feats"],
                               obj_valid=t["obj_valid"]))
    assert torch.isfinite(outs[0].logits).all()
    assert hold_call(*outs)["margins"]
    torch.testing.assert_close(outs[0].obj_logits.cpu(), outs[1].obj_logits,
                               rtol=RTOL, atol=ATOL)


def test_agent_batched_greedy_rollout_on_card_matches_cpu(cuda, tmp_path):
    """One lockstep rollout of 8 episodes on the card; every policy call
    replayed on the CPU with the same inputs; the card's per-episode
    metrics those of a CPU rollout."""
    from vln_ver_tpu_torch.agent.env import R2REnv, make_synthetic_vln
    from vln_ver_tpu_torch.agent.replay import PolicyCalls, replay
    from vln_ver_tpu_torch.agent.rollout import (episode_metrics,
                                                 run_episodes_batched)
    cfg, (card, cpu) = _agent_policies(cuda)
    episodes, graphs, ver = make_synthetic_vln(
        str(tmp_path), num_scans=2, nodes_per_scan=9, num_episodes=8,
        bev_num=32, embed_dims=cfg.embed_dims, vocab=cfg.vocab_size,
        max_text_len=cfg.max_text_len, seed=1)
    env = R2REnv(episodes, graphs, ver, max_nodes=cfg.max_nodes)
    with PolicyCalls(card, record=True) as rec:
        got, _ = run_episodes_batched(card, env, list(range(8)), cfg)
    held = replay(rec.calls, cpu)
    assert held["steps"] and held["compared"] > 0
    assert got == episode_metrics(cpu, env, cfg, batch_size=8)


def _agent_records(tmp_path, cfg, objects):
    from vln_ver_tpu_torch.agent.env import R2REnv, make_synthetic_vln
    from vln_ver_tpu_torch.agent.pretrain import collect_teacher_trace
    made = make_synthetic_vln(
        str(tmp_path), num_scans=2, nodes_per_scan=9, num_episodes=8,
        bev_num=32, embed_dims=cfg.embed_dims, vocab=cfg.vocab_size,
        max_text_len=cfg.max_text_len, seed=1, with_objects=objects)
    env = R2REnv(*made[:3], max_nodes=cfg.max_nodes,
                 objects=made[3] if objects else None)
    return [r for i in range(len(env.episodes))
            for r in collect_teacher_trace(env, i, cfg)]


@pytest.mark.parametrize("objects", [False, True], ids=["r2r", "reverie"])
def test_agent_imitation_update_on_card_matches_cpu(cuda, tmp_path, objects):
    """One imitation update's losses and gradients on the card against the
    CPU's, from the same weights and stacked batch (dropout off), with the
    bounds of chip_smoke.py phase 9 (agent/replay.py)."""
    from vln_ver_tpu_torch.agent.pretrain import stack_records
    from vln_ver_tpu_torch.agent.replay import hold_update, loss_and_grads
    from vln_ver_tpu_torch.agent.rollout import imitation_step_loss
    cfg, (card, cpu) = _agent_policies(cuda, grounding=objects)
    recs = _agent_records(tmp_path, cfg, objects)[:8]
    masks, res = [], {}
    for policy, dev, kw in ((cpu, "cpu", dict(record=masks)),
                            (card, cuda, dict(pin=masks))):
        batch = stack_records(recs, dev)
        res[str(dev)] = loss_and_grads(
            policy, lambda: imitation_step_loss(policy, batch), **kw)
    assert res["cpu"]["gnorm"] > 0
    assert ("ground_nll" in res["cpu"]["parts"]) and (
        (res["cpu"]["parts"]["ground_nll"] > 0) == objects)
    hold_update(res[str(cuda)], res["cpu"])


def test_agent_pretrain_update_on_card_matches_cpu(cuda, tmp_path):
    """One pretraining update's losses and gradients on the card against
    the CPU's: the same weights, batch and masked tokens, dropout off."""
    import torch

    from vln_ver_tpu_torch.agent.policy import PolicyConfig
    from vln_ver_tpu_torch.agent.pretrain import (VLNPretrainModel,
                                                  init_pretrain_params,
                                                  mask_tokens, stack_records)
    from vln_ver_tpu_torch.agent.replay import hold_update, loss_and_grads
    cfg = PolicyConfig(**AGENT_KW)
    recs = _agent_records(tmp_path, cfg, False)[:16]
    masked = mask_tokens(torch.Generator().manual_seed(0),
                         stack_records(recs)["instruction"], cfg.vocab_size)
    masks, res = [], {}
    for dev, kw in (("cpu", dict(record=masks)), (cuda, dict(pin=masks))):
        model = init_pretrain_params(VLNPretrainModel(cfg), 3).to(dev).eval()
        batch = stack_records(recs, dev)
        t = [m.to(dev) for m in masked]
        res[str(dev)] = loss_and_grads(
            model, lambda: (lambda p: (sum(p.values()), p))(
                model(batch, *t)), **kw)
    assert sorted(res["cpu"]["parts"]) == ["mlm", "sap", "total"]
    hold_update(res[str(cuda)], res["cpu"])


def test_temporal_models_on_card_match_cpu(cuda):
    """A TSA config with decoder_on_bev (mlp): the history roll over two
    frames and the full forward with prev_bev and tsa_shift, card against
    CPU; the SCA launches once a layer a frame, the decoder once a
    layer."""
    cfg = dataclasses.replace(TINY, use_temporal_self_attn=True,
                              decoder_on_bev=True)
    feats, w2p, shift = map(torch.from_numpy, _viewpoints(4))
    queue = [t.reshape(2, 2, *t.shape[1:]) for t in (feats, w2p, shift)]
    res = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev)
        before = KERNEL.launches
        prev = model.obtain_history_bev(*(t.to(dev) for t in queue))
        with torch.inference_mode():
            outs = model(*(t[:, -1].to(dev) for t in queue), prev_bev=prev,
                         tsa_shift=torch.full((2, 3), 0.05, device=dev))
        res[str(dev)] = (prev, outs, KERNEL.launches - before)
    (p0, o0, n0), (p1, o1, n1) = res["cpu"], res[str(cuda)]
    assert n0 == 0 and n1 == 3 * cfg.encoder_layers + cfg.decoder_layers
    torch.testing.assert_close(p1.cpu(), p0, rtol=1e-4, atol=1e-4)
    for k in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
        torch.testing.assert_close(o1[k].cpu(), o0[k], rtol=1e-4, atol=1e-4)


def test_bev2d_on_card_matches_cpu(cuda):
    """A small BEVFormer2D with prev_bev and can_bus: card against CPU,
    3 launches (SCA, TSA-2D, decoder) per layer pair; a two-level config
    raises before any launch."""
    from vln_ver_tpu_torch.models.bev2d import BEV2DConfig, build_bev2d
    cfg = BEV2DConfig(bev_h=6, bev_w=6, embed_dims=64, num_heads=4,
                      encoder_layers=2, decoder_layers=2, ffn_dim=128,
                      num_query=12, num_cams=3, feat_h=6, feat_w=6,
                      in_channels=64, use_shift=True, use_can_bus=True)
    feats, w2p, shift = map(torch.from_numpy, _viewpoints(2))
    rng = np.random.default_rng(1)
    can_bus = torch.from_numpy(rng.standard_normal((2, 18)).astype(
        np.float32))
    prev = torch.from_numpy(rng.standard_normal(
        (2, cfg.bev_num, cfg.embed_dims)).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda):
        model = build_bev2d(cfg, dev, seed=3)
        before = KERNEL.launches
        with torch.inference_mode():
            outs = model(*(t.to(dev) for t in (feats, w2p, shift)),
                         can_bus=can_bus.to(dev), prev_bev=prev.to(dev))
        res[str(dev)] = (outs, KERNEL.launches - before)
    (o0, n0), (o1, n1) = res["cpu"], res[str(cuda)]
    assert n0 == 0 and n1 == 2 * cfg.encoder_layers + cfg.decoder_layers
    for k in o0:
        torch.testing.assert_close(o1[k].cpu(), o0[k], rtol=1e-4, atol=1e-4)
    two = build_bev2d(dataclasses.replace(cfg, num_levels=2), cuda)
    with pytest.raises(ValueError, match="one level"):
        two(feats.to(cuda), w2p.to(cuda), shift.to(cuda))
