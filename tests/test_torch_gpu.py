"""The CUDA deformable-attention kernel against its plain version, on the
card.  Marked ``gpu``; each test skips where there is no card (decided in
the fixture, never at import, so every worker collects the same tests).

This file imports neither JAX nor the JAX package, so it also runs on a
host that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from vln_ver_tpu_torch.models import VERConfig, build_model
from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel
from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d
from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, ms_deform_attn_2d_fused

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ms_deform_attn_2d_fused(v.requires_grad_(), hw, locs, wsm)


TINY = VERConfig(num_cams=3, feat_h=6, feat_w=6, in_channels=64,
                 embed_dims=64, num_heads=4, encoder_layers=2, ffn_dim=128,
                 bev_z=2, bev_h=5, bev_w=5)


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
            outs = model(f, m, s)
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
        ref = build_model(cfg, "cpu")(feats, w2p, shift)["bev_embed"]
        before = KERNEL.launches
        got = build_model(cfg, cuda)(feats.to(cuda), w2p.to(cuda),
                                     shift.to(cuda))["bev_embed"]
        torch.cuda.synchronize()
    assert KERNEL.launches == before + cfg.encoder_layers
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
