"""The port's refine_occ upsampler (``models.head.OccUpsampler``, the even-
grid factorisation of the reference's transposed convolutions) on the CPU:
against JAX's ``OccUpsampler`` on the weights ``state_dict_from_jax``
carries across, at 1, 2 and 3 stages and bev_z = 2, 3 and 4 (z = 2 runs
only the middle z-tap; 3 and 4 the k = 0 and k = 2 taps too), in fp32
within rtol 1e-4 / atol 5e-5 and in bf16 within rtol 2e-2 / atol 2e-2
(tests/test_torch_bf16.py's bound); against the dense ConvTranspose3d
stack on the same parameters (``dense_reference``), outputs within atol
2e-5 / rtol 1e-5 (the JAX package's own test,
tests/test_model_forward.py::test_upsampler_matches_conv_transpose) and
the gradients of the input, weights and biases within rtol 1e-4 / atol
1e-5; the z-major route (each stage's z-tap convolutions summed by
``ops.up_assemble``'s plain assembly, the composition the card's kernel
computes) against JAX, the stack-and-add path and the dense stack at the
same tolerances; and that no occupancy layout reaches
``F.conv_transpose3d``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_decoder import JCFG, jax_params

from vln_ver_tpu.models.head import OccUpsampler as JaxOccUpsampler
from vln_ver_tpu.models.head import _UpStage as JaxUpStage
from vln_ver_tpu_torch.convert import state_dict_from_jax
from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel
from vln_ver_tpu_torch.models import build_model
from vln_ver_tpu_torch.models.config import VERConfig
from vln_ver_tpu_torch.models.head import OccUpsampler, dense_reference
from vln_ver_tpu_torch.ops import up_assemble

torch.set_num_threads(1)

C = 16
# 3 x 3 voxel grid, 0.5 m cells over 12 m: 3 stages, 3 -> 24
JUP = dataclasses.replace(JCFG, embed_dims=C, in_channels=C, bev_h=3,
                          bev_w=3, occupancy_size=(0.5, 0.5, 0.5),
                          occ_layout="zhwc")
TOL = {torch.float32: dict(rtol=1e-4, atol=5e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", list(TOL), ids=["fp32", "bf16"])
Z = pytest.mark.parametrize("z", [2, 3, 4])


@pytest.fixture(scope="module")
def weights():
    """(JAX's up_sample tree, the port's up_sample state_dict), 3 stages,
    non-zero biases; the port's carried across by state_dict_from_jax."""
    params = jax_params(JUP, seed=4)
    sd, unmapped = state_dict_from_jax(params, VERConfig(**{
        f.name: getattr(JUP, f.name) for f in dataclasses.fields(VERConfig)
        if f.name != "dtype"}))
    assert not unmapped
    prefix = "pts_bbox_head.up_sample."
    return (params["pts_bbox_head"]["up_sample"],
            {k[len(prefix):]: v for k, v in sd.items()
             if k.startswith(prefix)})


def _pair(weights, stages, dtype):
    """The port's upsampler of the first ``stages`` stages."""
    up = OccUpsampler(C, stages, dtype)
    up.load_state_dict({k: v for k, v in weights[1].items()
                        if int(k.split(".")[0]) < stages})
    return up


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


def _jax_all(tree, x, e, dtype):
    """Everything the JAX side is held to at one (z, dtype), for one jit:
    stage 1's ``even_conv`` of ``x``, its ``phase_conv`` of ``e`` (stage
    0's bias) and ``interleave`` of ``e``; and for 1, 2 and 3 stages
    ``informative`` and the full output of ``x``."""
    p1 = {"params": tree["up1"]}
    stage = JaxUpStage(C, dtype=dtype)
    ed = e.astype(dtype)
    out = {"even_conv": stage.apply(p1, x, method="even_conv"),
           "phase_conv": stage.apply(p1, ed, tree["up0"]["bias"],
                                     method="phase_conv"),
           "interleave": stage.apply(p1, ed, method="interleave")}
    out["stages"] = []
    for n in (1, 2, 3):
        mod = JaxOccUpsampler(C, num_stages=n, dtype=dtype)
        p = {"params": {f"up{i}": tree[f"up{i}"] for i in range(n)}}
        out["stages"].append((mod.apply(p, x, method="informative"),
                              mod.apply(p, x)))
    return out


@pytest.fixture(scope="module")
def jax_refs(weights):
    """(z, dtype) -> ``_jax_all`` on the inputs of the tests below, jitted
    once a pair (JAX's op-by-op dispatch compiles every convolution shape
    apart, several times slower on the CPU)."""
    cache = {}

    def get(z, dtype):
        if (z, dtype) not in cache:
            fn = jax.jit(functools.partial(_jax_all, dtype=JAX_DTYPE[dtype]))
            cache[z, dtype] = jax.device_get(fn(
                weights[0], jnp.asarray(_x((2, z, 3, 4, C), 1)),
                jnp.asarray(_x((2, z, 3, 4, C), 2))))
        return cache[z, dtype]
    return get


@DTYPES
@Z
def test_stage_methods_match_jax(weights, jax_refs, z, dtype):
    """``even_conv``, ``phase_conv`` (with the bias profile of the
    previous stage's bias) and ``interleave`` of one stage against JAX's,
    on a (3, 4) grid so that y and x cannot trade places."""
    up = _pair(weights, 2, dtype)
    ref = jax_refs(z, dtype)
    x = torch.from_numpy(_x((2, z, 3, 4, C), 1))
    e = torch.from_numpy(_x((2, z, 3, 4, C), 2)).to(dtype)
    with torch.inference_mode():
        _close(up[1].even_conv(x), ref["even_conv"], dtype)
        _close(up[1].phase_conv(e, up[0].bias), ref["phase_conv"], dtype)
        _close(up[1].interleave(e), ref["interleave"], dtype)


@DTYPES
@Z
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_upsampler_matches_jax(weights, jax_refs, stages, z, dtype):
    """``informative`` (the final even grid and the last bias) and the
    full output against JAX's ``OccUpsampler``."""
    up = _pair(weights, stages, dtype)
    (e_ref, bias_ref), full_ref = jax_refs(z, dtype)["stages"][stages - 1]
    x = torch.from_numpy(_x((2, z, 3, 4, C), 1))
    with torch.inference_mode():
        e, bias = up.informative(x)
        full = up(x)
    k = 2 ** (stages - 1)
    assert tuple(e.shape) == e_ref.shape == (2, z, 3 * k, 4 * k, C)
    assert tuple(full.shape) == full_ref.shape == (2, z, 6 * k, 8 * k, C)
    assert e.dtype == full.dtype == dtype
    _close(e, e_ref, dtype)
    np.testing.assert_array_equal(bias.detach().numpy(), bias_ref)
    _close(full, full_ref, dtype)
    if stages == 1:     # a stage called alone: the same NDHWC function
        with torch.inference_mode():
            torch.testing.assert_close(up[0](x), full, rtol=0, atol=0)


@DTYPES
@Z
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_assembly_matches_jax_and_the_stack_path(weights, jax_refs,
                                                 monkeypatch, stages, z,
                                                 dtype):
    """The z-major route, forced on the CPU (where ``assemble`` is its
    plain version): ``informative`` and the full output against JAX's and
    against the stack-and-add path, and in fp32 against the dense
    stack."""
    up = _pair(weights, stages, dtype)
    (e_ref, _), full_ref = jax_refs(z, dtype)["stages"][stages - 1]
    x = torch.from_numpy(_x((2, z, 3, 4, C), 1))
    with torch.inference_mode():
        e_stack, full_stack = up.informative(x)[0], up(x)
        monkeypatch.setattr(up_assemble, "route", lambda *a: True)
        (e, bias), full = up.informative(x), up(x)
    assert e.shape == e_stack.shape and e.dtype == dtype
    assert e.transpose(0, 1).is_contiguous()    # a view of the z-major grid
    assert bias is up[-1].bias
    for got, jax_ref, stack in ((e, e_ref, e_stack),
                                (full, full_ref, full_stack)):
        _close(got, jax_ref, dtype)
        torch.testing.assert_close(got.float(), stack.float(), **TOL[dtype])
    if dtype == torch.float32:
        dense = dense_reference(up)
        with torch.no_grad():
            ref = dense(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        torch.testing.assert_close(full, ref, atol=2e-5, rtol=1e-5)


@Z
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_factorised_matches_dense_reference(weights, stages, z):
    """The factorised route against the dense ConvTranspose3d stack on the
    same parameters: the full output, ``informative``'s even cells, and
    the gradients of the input, every weight and every bias."""
    up = _pair(weights, stages, torch.float32)
    dense = dense_reference(up)
    x = torch.from_numpy(_x((2, z, 3, 4, C), 5)).requires_grad_()
    params = [p for s in up for p in (s.weight, s.bias)]
    got = up(x)
    ref = dense(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-5)
    e, bias = up.informative(x)
    torch.testing.assert_close(e + bias, ref[:, :, ::2, ::2], atol=2e-5,
                               rtol=1e-5)
    g = torch.from_numpy(_x(tuple(got.shape), 6))
    grads = torch.autograd.grad(got, [x, *params], g)
    grads_ref = torch.autograd.grad(ref, [x, *params], g)
    for a, b in zip(grads, grads_ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_state_dict_is_the_reference_stack(weights):
    """The reference's names and torch's ConvTranspose3d shapes:
    ``{i}.weight`` (in, out, 3, 5, 5) and ``{i}.bias``, the keys of the
    dense stack (and of a reference checkpoint's ``up_sample``)."""
    up = OccUpsampler(C, 3)
    shapes = {k: tuple(v.shape) for k, v in up.state_dict().items()}
    assert shapes == {k: tuple(v.shape)
                      for k, v in dense_reference(up).state_dict().items()}
    assert shapes == {**{f"{i}.weight": (C, C, 3, 5, 5) for i in range(3)},
                      **{f"{i}.bias": (C,) for i in range(3)}}
    assert list(shapes) == list(weights[1])


def _refuse(*args, **kwargs):
    raise AssertionError("F.conv_transpose3d reached")


@pytest.mark.parametrize("layout", ["zhwc", "zhwc_dense", "ref"])
def test_no_layout_calls_conv_transpose3d(monkeypatch, layout):
    """A full forward and backward of the model at bev_z = 3 in each
    occupancy layout with ``F.conv_transpose3d`` patched to raise; the
    dense reference does raise under the patch."""
    monkeypatch.setattr(F, "conv_transpose3d", _refuse)
    monkeypatch.setattr(torch, "conv_transpose3d", _refuse)
    cfg = VERConfig(num_cams=2, feat_h=4, feat_w=4, in_channels=16,
                    embed_dims=C, num_heads=2, encoder_layers=1, ffn_dim=32,
                    bev_z=3, bev_h=3, bev_w=3, decoder_layers=1, num_query=4,
                    num_classes=3, occupancy_classes=4, occ_dims=8,
                    occupancy_size=(2.0, 2.0, 0.5), occ_layout=layout)
    model = build_model(cfg, "cpu", seed=0)
    feats = torch.from_numpy(_x((1, 2, 4, 4, 16), 7))
    w2p = torch.from_numpy(np.stack([make_pinhole_world2pixel(
        70.0, deg, np.zeros(3, np.float32)) for deg in (0.0, 180.0)])[None])
    outs = model(feats, w2p, torch.zeros(1, 3))
    assert outs["occupancy_preds"].shape == (1, cfg.voxel_num, 4)
    outs["occupancy_preds"].sum().backward()
    up = model.pts_bbox_head.up_sample
    assert all(s.weight.grad is not None and s.weight.grad.abs().sum() > 0
               for s in up)
    with pytest.raises(AssertionError, match="conv_transpose3d"):
        dense_reference(up)(torch.zeros(1, C, 3, 3, 3))
