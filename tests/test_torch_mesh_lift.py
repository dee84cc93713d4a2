"""The port's lift over a (data, view) process grid, fp32 on the CPU at the
tiny config (configs/verformer/vocc_tiny.py), gloo processes.

* 4 processes as a (2, 2) mesh and as (4, 1), and 2 processes as (1, 2),
  on the dense and the sparse lift: each rank's rows of ``bev_embed``
  against the 1-process port (rtol 1e-5 / atol 1e-6, the view all-reduce
  changes only the order of the camera sum) with the same
  ``sca_overflow``, and against JAX's ``VoxelFormer`` on a
  ``make_mesh((4, 2))`` of the same weights (rtol 1e-4 / atol 2e-5, the
  port's bound against JAX).
* the fused image path on the same meshes (uint8 views, a 1-layer ViT
  of seed 1 on each rank's cameras only) against the 1-process port, rtol
  1e-5 / atol 1e-6;
* ``get_occ --mesh 2,2`` over 4 processes: the union of the shard files
  is the 1-process dump, key for key, within rtol 1e-5.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import launch, worker_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
B = 4
CAPACITY = 8      # below the 12 visible queries: a real sparse lift


def _port_model(pth, capacity):
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.convert import load_checkpoint
    from vln_ver_tpu_torch.models import build_model
    ver = dataclasses.replace(build_ver_config(load_config(CONFIG)),
                              sca_query_capacity=capacity)
    model = build_model(ver, "cpu", seed=0)
    load_checkpoint(model, pth)
    return model


def _lift(model, inputs, vit=None):
    from vln_ver_tpu_torch.get_occ import make_bev_only
    bev, ovf = make_bev_only(model, vit)(*(torch.from_numpy(np.asarray(a))
                                           for a in inputs))
    return bev.numpy(), int(ovf)


def _vit():
    """A 1-layer ViT of the tiny config's 4 x 4 grid, patch 8, seed 1."""
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.models.vit import vit_for_ver
    ver = build_ver_config(load_config(CONFIG))
    return vit_for_ver(ver, patch_size=8, num_layers=1, num_heads=4
                       ).init_weights(torch.Generator().manual_seed(1)
                                      ).eval()


# ---- workers ----------------------------------------------------------------

def lift_worker(out: str, pth: str, inputs: str, shapes: list,
                dump: dict = None) -> None:
    from vln_ver_tpu_torch.parallel import multihost
    from vln_ver_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                 shard_batch)
    rank = multihost.process_index()
    z = np.load(inputs)
    batch = {k: z[k] for k in ("features", "world2pixel", "origin_shift",
                               "images")}
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape))
        local = shard_batch(mesh, batch)
        for cap in (0, CAPACITY):
            model = replicate(mesh, _port_model(pth, cap))
            model.shard_views(mesh.views)
            bev, ovf = _lift(model, [local[k] for k in
                                     ("features", "world2pixel",
                                      "origin_shift")])
            tag = f"{shape[0]}x{shape[1]}_{cap}"
            res[f"bev_{tag}"], res[f"ovf_{tag}"] = bev, ovf
            res[f"index_{tag}"] = (mesh.data_index, mesh.view_index)
        res[f"img_{shape[0]}x{shape[1]}"], _ = _lift(
            model, [local[k] for k in ("images", "world2pixel",
                                       "origin_shift")],
            replicate(mesh, _vit()))
    np.savez(f"{out}.{rank}.npz", **res)
    if dump:
        from vln_ver_tpu_torch import get_occ
        get_occ.main(dump["argv"])


# ---- tests ------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX weights (perturbed off the flax init), their .pth export, B
    viewpoints of inputs, and the JAX (4, 2)-mesh lifts of both."""
    import jax

    from vln_ver_tpu.config import build_ver_config, load_config
    from vln_ver_tpu.convert import export_state_dict
    from vln_ver_tpu.models import VoxelFormer
    from vln_ver_tpu.parallel import make_mesh, replicate, shard_batch
    from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel

    tmp = tmp_path_factory.mktemp("mesh_lift")
    # two 120-degree cameras (up to 12 of the 32 queries in one camera):
    # at 90 degrees they put voxel centres exactly on an image edge, where
    # the strict in-image mask is decided by the last bit of the
    # projection
    ver = build_ver_config(load_config(CONFIG))
    rng = np.random.default_rng(0)
    pos = (rng.uniform(-1, 1, (B, 3)) * [1, 1, 0.3]).astype(np.float32)
    batch = dict(
        features=rng.standard_normal((B, ver.num_cams, ver.feat_h,
                                      ver.feat_w, ver.in_channels)
                                     ).astype(np.float32),
        world2pixel=np.stack([np.stack([
            make_pinhole_world2pixel(120.0, k * 360.0 / ver.num_cams, p)
            for k in range(ver.num_cams)]) for p in pos]).astype(np.float32),
        origin_shift=pos,
        images=rng.integers(0, 256, (B, ver.num_cams, 8 * ver.feat_h,
                                     8 * ver.feat_w, 3)).astype(np.uint8))
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **batch)
    params = jax.jit(VoxelFormer(ver).init)(
        jax.random.PRNGKey(0), batch["features"][:1],
        batch["world2pixel"][:1], batch["origin_shift"][:1])["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)
    pth = str(tmp / "export.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               export_state_dict(params, ver).items()}}, pth)
    mesh = make_mesh((4, 2))
    jax_bev = {}
    for cap in (0, CAPACITY):
        m = VoxelFormer(dataclasses.replace(ver, sca_query_capacity=cap))
        fn = jax.jit(lambda p, f, w, s, m=m: m.apply(
            p, f, w, s, only_bev=True)["bev_embed"])
        with mesh:
            jax_bev[cap] = np.asarray(fn(
                replicate(mesh, {"params": params}),
                *(shard_batch(mesh, batch)[k] for k in
                  ("features", "world2pixel", "origin_shift"))))
    return tmp, pth, inputs, batch, jax_bev


def _held(setup, outs, world, shapes):
    tmp, pth, _, batch, jax_bev = setup
    inputs = [batch[k] for k in ("features", "world2pixel", "origin_shift")]
    # the last model each worker built has CAPACITY: so has this one
    ref_img, _ = _lift(_port_model(pth, CAPACITY),
                       [batch[k] for k in ("images", "world2pixel",
                                           "origin_shift")], _vit())
    for shape in shapes:
        for rank in range(world):
            di = rank // shape[1]
            rows = slice(di * B // shape[0], (di + 1) * B // shape[0])
            np.testing.assert_allclose(
                np.load(f"{outs}.{rank}.npz")[f"img_{shape[0]}x{shape[1]}"],
                ref_img[rows], rtol=1e-5, atol=1e-6, err_msg=str(shape))
    for cap in (0, CAPACITY):
        ref, ref_ovf = _lift(_port_model(pth, cap), inputs)
        if cap:
            assert ref_ovf > 0     # the capacity drops queries
        for shape in shapes:
            tag = f"{shape[0]}x{shape[1]}_{cap}"
            d = shape[0]
            for rank in range(world):
                z = np.load(f"{outs}.{rank}.npz")
                di, vi = z[f"index_{tag}"]
                assert (di, vi) == divmod(rank, shape[1])
                rows = slice(di * B // d, (di + 1) * B // d)
                got = z[f"bev_{tag}"]
                np.testing.assert_allclose(got, ref[rows], rtol=1e-5,
                                           atol=1e-6, err_msg=tag)
                np.testing.assert_allclose(got, jax_bev[cap][rows],
                                           rtol=1e-4, atol=2e-5,
                                           err_msg=tag)
                assert int(z[f"ovf_{tag}"]) == ref_ovf, tag


def test_four_processes_and_mesh_dump(setup, tmp_path):
    import h5py

    from vln_ver_tpu_torch import get_occ
    _, pth, inputs, _, _ = setup
    root = str(tmp_path / "data")
    argv = [CONFIG, "--device", "cpu", "--synthetic", "--checkpoint", pth,
            "--batch-size", "2", "--cfg-options",
            f"data.test.data_root={root}",
            f"data.test.ann_file={root}/mp3d_forall.pkl"]
    outs = str(tmp_path / "lift")
    launch(4, __file__, "lift_worker", timeout=150, out=outs, pth=pth,
           inputs=inputs, shapes=[[2, 2], [4, 1]],
           dump=dict(argv=argv + ["--out", str(tmp_path / "mesh.h5"),
                                  "--mesh", "2,2"]))
    _held(setup, outs, 4, [(2, 2), (4, 1)])

    single = str(tmp_path / "single.h5")
    get_occ.main(argv + ["--out", single])
    shards = sorted(glob.glob(str(tmp_path / "mesh.h5.shard*")))
    assert [os.path.basename(p) for p in shards] == [
        "mesh.h5.shard0", "mesh.h5.shard1"]
    union = {}
    for p in shards:
        with h5py.File(p, "r") as f:
            for k in f:
                assert k not in union
                union[k] = f[k][:]
    with h5py.File(single, "r") as f:
        assert sorted(f) == sorted(union) and len(union) == 4
        for k in f:
            np.testing.assert_allclose(union[k], f[k][:], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_two_processes_view_only(setup, tmp_path):
    outs = str(tmp_path / "lift")
    launch(2, __file__, "lift_worker", timeout=120, out=outs,
           pth=setup[1], inputs=setup[2], shapes=[[1, 2]])
    _held(setup, outs, 2, [(1, 2)])


if __name__ == "__main__":
    worker_main(globals())
