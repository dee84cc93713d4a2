"""The capacity-bounded sparse lift of the port against its dense lift and
against the JAX package's sparse lift, fp32 on the CPU.

* Port sparse vs port dense (SpatialCrossAttention with the same weights):
  rtol 2e-5 / atol 2e-5, gradients rtol 5e-4 / atol 1e-5, JAX's own bounds
  (tests/test_sparse_lift.py:53,72).
* The port's capacity VoxelFormer vs JAX's on the tiny config
  (configs/verformer/vocc_tiny.py): rtol 1e-4 / atol 2e-5 on bev_embed,
  atol 5e-5 on the heads.
* A capacity below the visible count: the same ``sca_overflow`` as JAX
  and the same output, so the same queries were dropped (JAX's top-k keeps
  the lowest-index visible queries; the port's stable sort must too).
* ``geometry.max_visible_queries`` returns JAX's integer, and the
  ``check_query_capacity`` entry point exits as the JAX tool does."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_ver_tpu import geometry as jgeo
from vln_ver_tpu.config import build_ver_config as jax_build_ver_config
from vln_ver_tpu.config import load_config as jax_load_config
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.models.attention import (
    SpatialCrossAttention as JaxSpatialCrossAttention)
from vln_ver_tpu_torch import check_query_capacity, geometry
from vln_ver_tpu_torch.config import build_ver_config, load_config
from vln_ver_tpu_torch.convert import state_dict_from_jax
from vln_ver_tpu_torch.models import VoxelFormer
from vln_ver_tpu_torch.models.attention import SpatialCrossAttention

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
C, HEADS, POINTS, HW = 32, 4, 4, (7, 7)


def _sca_inputs(seed=0, bsz=2, cams=4, nq=60, max_vis=20):
    """JAX's test inputs: each camera sees 3..max_vis random queries."""
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((bsz, nq, C)).astype(np.float32)
    value = rng.standard_normal((bsz, cams, HW[0] * HW[1], C)).astype(
        np.float32)
    ref = rng.uniform(0.1, 0.9, (bsz, cams, nq, 1, 2)).astype(np.float32)
    mask = np.zeros((bsz, cams, nq, 1), bool)
    for b in range(bsz):
        for cam in range(cams):
            vis = rng.choice(nq, size=rng.integers(3, max_vis + 1),
                             replace=False)
            mask[b, cam, vis, :] = True
    return query, value, ref, mask


def _jax_sca(cap):
    return JaxSpatialCrossAttention(embed_dims=C, num_heads=HEADS,
                                    num_points=POINTS, dropout_rate=0.0,
                                    deform_impl="gather",
                                    query_capacity=cap)


@pytest.fixture(scope="module")
def sca_params():
    """JAX SCA parameters, moved off the flax init (its zero offset and
    attention kernels would leave the gathered rows untested)."""
    args = _sca_inputs()
    params = _jax_sca(0).init(jax.random.PRNGKey(0),
                              *map(jnp.asarray, args), (HW,))["params"]
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


def _port_sca(params, cap):
    m = SpatialCrossAttention(C, HEADS, 1, POINTS, query_capacity=cap,
                              dropout_rate=0.0)
    sd = {}
    for path, leaf in (("deformable_attention.value_proj",
                        params["deformable_attention"]["value_proj"]),
                       ("deformable_attention.sampling_offsets",
                        params["deformable_attention"]["sampling_offsets"]),
                       ("deformable_attention.attention_weights",
                        params["deformable_attention"]["attention_weights"]),
                       ("output_proj", params["output_proj"])):
        sd[path + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaf["kernel"]).T))
        sd[path + ".bias"] = torch.from_numpy(np.asarray(leaf["bias"]))
    m.load_state_dict(sd, strict=True)
    return m.eval()


@pytest.mark.parametrize("cap", [24, 32, 60])   # >= max visible; 60 = nq
def test_sparse_matches_dense_and_jax(sca_params, cap):
    args = _sca_inputs()
    targs = [torch.from_numpy(a) for a in args]
    with torch.inference_mode():
        dense = _port_sca(sca_params, 0)(*targs, (HW,))
        sparse = _port_sca(sca_params, cap)(*targs, (HW,))
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-5)
    ref = _jax_sca(cap).apply({"params": sca_params},
                              *map(jnp.asarray, args), (HW,))
    np.testing.assert_allclose(sparse.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-5)


def test_sparse_matches_dense_gradients(sca_params):
    """Gradients of every parameter and of the query and value, through
    the gather of the offsets and weights and the scatter back."""
    args = _sca_inputs(seed=1)
    grads = []
    for cap in (0, 32):
        m = _port_sca(sca_params, cap)
        q, v = (torch.from_numpy(a).requires_grad_() for a in args[:2])
        out = m(q, v, torch.from_numpy(args[2]), torch.from_numpy(args[3]),
                (HW,))
        w = torch.cos(torch.arange(out.numel(), dtype=torch.float32)
                      .reshape(out.shape) * 0.01)
        (out * w).sum().backward()
        grads.append({**{n: p.grad for n, p in m.named_parameters()},
                      "query": q.grad, "value": v.grad})
    dense, sparse = grads
    assert dense.keys() == sparse.keys()
    for k in dense:
        np.testing.assert_allclose(sparse[k].numpy(), dense[k].numpy(),
                                   rtol=5e-4, atol=1e-5, err_msg=k)


def test_overflowing_sca_drops_what_jax_drops(sca_params):
    """K = 8 below the up-to-30 visible queries a camera sees: the port
    keeps the same 8 (the lowest-index visible ones) as JAX's stable
    top-k, so the outputs agree, and both differ from the dense lift."""
    args = _sca_inputs(seed=3, max_vis=30)
    with torch.inference_mode():
        got = _port_sca(sca_params, 8)(*map(torch.from_numpy, args), (HW,))
        dense = _port_sca(sca_params, 0)(*map(torch.from_numpy, args),
                                         (HW,))
    ref = _jax_sca(8).apply({"params": sca_params}, *map(jnp.asarray, args),
                            (HW,))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-5)
    assert not np.allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)


def _tiny_inputs(ver, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((batch, ver.num_cams, ver.feat_h, ver.feat_w,
                                 ver.in_channels)).astype(np.float32)
    pos = (rng.uniform(-1.0, 1.0, (batch, 3))
           * np.array([1, 1, 0.3])).astype(np.float32)
    w2p = np.stack([np.stack([
        jgeo.make_pinhole_world2pixel(70.0, deg * 360.0 / ver.num_cams, p)
        for deg in range(ver.num_cams)]) for p in pos]).astype(np.float32)
    return feats, w2p, pos


@pytest.fixture(scope="module")
def tiny():
    """The tiny config in both packages, JAX weights moved off the flax
    init, and the inputs of two viewpoints."""
    jver = dataclasses.replace(jax_build_ver_config(jax_load_config(CONFIG)),
                               dropout_rate=0.0)
    ver = dataclasses.replace(build_ver_config(load_config(CONFIG)),
                              dropout_rate=0.0)
    feats, w2p, shift = _tiny_inputs(ver)
    params = JaxVoxelFormer(jver).init(jax.random.PRNGKey(0), feats, w2p,
                                       shift)["params"]
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)
    return jver, ver, params, (feats, w2p, shift)


def _both(tiny, cap):
    jver, ver, params, inputs = tiny
    jver = dataclasses.replace(jver, sca_query_capacity=cap)
    ver = dataclasses.replace(ver, sca_query_capacity=cap)
    ref = JaxVoxelFormer(jver).apply({"params": params},
                                     *map(jnp.asarray, inputs))
    sd, not_ported = state_dict_from_jax(params, ver)
    assert not not_ported
    model = VoxelFormer(ver)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = model.eval()(*map(torch.from_numpy, inputs))
    return got, ref


_HEADS = ("all_cls_scores", "all_bbox_preds", "occupancy_preds")


def test_capacity_voxelformer_matches_jax(tiny):
    _, ver, _, (_, w2p, shift) = tiny
    need = geometry.max_visible_queries(w2p, shift, ver.bev_z, ver.bev_h,
                                        ver.bev_w, ver.pc_range)
    assert 0 < need < ver.bev_num
    got, ref = _both(tiny, need)
    assert int(got["sca_overflow"]) == int(ref["sca_overflow"]) == 0
    np.testing.assert_allclose(got["bev_embed"].numpy(),
                               np.asarray(ref["bev_embed"]), rtol=1e-4,
                               atol=2e-5)
    for k in _HEADS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("keep", [0.5, 0.9])
def test_overflowing_capacity_matches_jax(tiny, keep):
    """K below the visible count: the port's ``sca_overflow`` is JAX's
    (the worst camera's visible count, from the projection's own mask,
    minus K), and the dropped queries are JAX's (the outputs agree)."""
    _, ver, _, (_, w2p, shift) = tiny
    _, mask = geometry.project_reference_points(
        geometry.voxel_reference_points(ver.bev_z, ver.bev_h, ver.bev_w),
        torch.from_numpy(w2p), torch.from_numpy(shift), ver.pc_range)
    visible = int(mask.sum(-1).max())
    cap = int(keep * visible)
    got, ref = _both(tiny, cap)
    assert int(got["sca_overflow"]) == int(ref["sca_overflow"]) \
        == visible - cap > 0
    assert isinstance(got["sca_overflow"], torch.Tensor)
    np.testing.assert_allclose(got["bev_embed"].numpy(),
                               np.asarray(ref["bev_embed"]), rtol=1e-4,
                               atol=2e-5)
    for k in _HEADS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("num_cams,batch,seed", [(6, 3, 0), (6, 1, 1),
                                                 (2, 4, 2)])
def test_max_visible_queries_matches_jax(num_cams, batch, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.0, 2.0, (batch, 3)).astype(np.float32)
    w2p = np.stack([np.stack([
        jgeo.make_pinhole_world2pixel(rng.uniform(50, 100),
                                      deg * 360.0 / num_cams, p)
        for deg in range(num_cams)]) for p in pos])
    for dims in ((4, 15, 15), (2, 4, 4)):
        got = geometry.max_visible_queries(w2p, pos, *dims)
        assert isinstance(got, int)
        assert got == jgeo.max_visible_queries(w2p, pos, *dims)


def test_check_query_capacity_exit_codes(tmp_path, capsys):
    root = str(tmp_path / "data")
    opts = ["--synthetic", "--split", "test", "--cfg-options",
            f"data.test.data_root={root}",
            f"data.test.ann_file={root}/mp3d_test.pkl"]
    assert check_query_capacity.main([CONFIG, *opts]) == 0
    out = capsys.readouterr().out
    worst = int(out.split("minimum safe sca_query_capacity: ")[1]
                .split(";")[0])
    assert 0 < worst <= 32
    assert check_query_capacity.main([CONFIG, *opts, "--capacity",
                                      str(worst)]) == 0
    assert f"capacity {worst} ok" in capsys.readouterr().out
    assert check_query_capacity.main([CONFIG, *opts, "--capacity",
                                      str(worst - 1)]) == 1
    assert "INSUFFICIENT" in capsys.readouterr().out
    # the JAX tool on the same data finds the same worst count
    jax_tool = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "check_query_capacity.py"),
         CONFIG, *opts, "--capacity", str(worst - 1)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert jax_tool.returncode == 1, jax_tool.stderr
    assert f"minimum safe sca_query_capacity: {worst};" in jax_tool.stdout
    # as its own entry point
    cli = subprocess.run(
        [sys.executable, "-m", "vln_ver_tpu_torch.check_query_capacity",
         CONFIG, *opts, "--capacity", str(worst)], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert cli.returncode == 0, cli.stderr


@pytest.mark.parametrize("cli", ["test", "train"])
def test_clis_fail_fast_on_an_overflowing_capacity(cli, tmp_path,
                                                   monkeypatch):
    """The eval CLI and the train CLI stop with the overflow message when
    the capacity drops visible queries, as tools/test.py and
    tools/train.py do (get_occ: tests/test_torch_get_occ.py)."""
    from vln_ver_tpu_torch import test as test_cli
    from vln_ver_tpu_torch.train.cli import main as train_main
    monkeypatch.chdir(tmp_path)
    args = [CONFIG, "--device", "cpu", "--synthetic", "--cfg-options",
            "sca_query_capacity=1"]
    with pytest.raises(SystemExit, match="sca_query_capacity overflow"):
        if cli == "test":
            test_cli.main(args + ["--limit", "2"])
        else:
            train_main(args + ["--max-steps", "1", "--log-interval", "1",
                               "--work-dir", "wd"])
