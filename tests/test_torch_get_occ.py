"""The port's VER dump against the JAX package's, on the CPU at the tiny
config (configs/verformer/vocc_tiny.py).

The JAX weights are exported exactly as ``tools/export_voxelformer.py``
writes them (``{"state_dict", "meta"}``) and handed to the port's
``get_occ`` CLI with ``--checkpoint``; both packages generate their own
synthetic inputs from the same seed.  The files must agree in keys,
(C, Z, H, W) shapes, fp32, gzip and values (rtol 1e-4 / atol 2e-5)."""

import os
import pickle

import h5py
import jax
import numpy as np
import pytest
import torch

from vln_ver_tpu.config import build_ver_config as jax_build_ver_config
from vln_ver_tpu.config import load_config as jax_load_config
from vln_ver_tpu.convert import export_state_dict
from vln_ver_tpu.data import MP3DDataset as JaxMP3DDataset
from vln_ver_tpu.data import make_synthetic_dataset as jax_make_synthetic
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.ver_writer import dump_volumes as jax_dump_volumes
from vln_ver_tpu_torch import get_occ
from vln_ver_tpu_torch.config import build_ver_config, load_config
from vln_ver_tpu_torch.data import MP3DDataset
from vln_ver_tpu_torch.models import build_model
from vln_ver_tpu_torch.parallel.mesh import Mesh
from vln_ver_tpu_torch.ver_writer import dump_volumes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")


def _read_all(path):
    out = {}
    with h5py.File(path, "r") as f:
        for k in f:
            assert f[k].compression == "gzip", k
            out[k] = f[k][:]
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX weights (full tree, perturbed off the flax init), their .pth
    export and the JAX dump of the synthetic 'forall' split."""
    tmp = tmp_path_factory.mktemp("jax")
    ver = jax_build_ver_config(jax_load_config(CONFIG))
    root = str(tmp / "data")
    ann = jax_make_synthetic(root, split="forall", num_cams=ver.num_cams,
                             feat_hw=ver.feat_h, feat_dim=ver.in_channels,
                             occ_dims=(ver.occ_zdim, ver.occ_ydim,
                                       ver.occ_xdim), pc_range=ver.pc_range)
    dataset = JaxMP3DDataset(ann, root, voxel_num=ver.voxel_num,
                             occupancy_classes=ver.occupancy_classes,
                             num_cams=ver.num_cams, feat_hw=ver.feat_h,
                             test_mode=True)
    s0 = dataset[0]
    model = JaxVoxelFormer(ver)
    params = model.init(jax.random.PRNGKey(0), s0["features"][None],
                        s0["world2pixel"][None],
                        s0["origin_shift"][None])["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)
    pth = str(tmp / "export.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               export_state_dict(params, ver).items()},
                "meta": {"framework": "vln_ver_tpu", "step": 0}}, pth)

    @jax.jit
    def bev_only(p, feats, w2p, shift):
        outs = model.apply(p, feats, w2p, shift, only_bev=True)
        return outs["bev_embed"], outs["sca_overflow"]

    out = str(tmp / "jax_ver.h5")
    res = jax_dump_volumes(bev_only, {"params": params}, ver, dataset, out,
                           batch_size=3, serial=True)
    assert res["written"] == len(dataset) == 4
    return root, pth, out, params


def _port_cli(tmp_path, pth, name, *extra):
    root = str(tmp_path / "data")
    out = str(tmp_path / name)
    res = get_occ.main([
        CONFIG, "--device", "cpu", "--synthetic", "--checkpoint", pth,
        "--out", out, "--batch-size", "3", "--cfg-options",
        f"data.test.data_root={root}",
        f"data.test.ann_file={root}/mp3d_forall.pkl", *extra])
    return root, out, res


def test_port_dump_matches_jax_dump(jax_run, tmp_path, capsys):
    jroot, pth, jout, _ = jax_run
    root, out, res = _port_cli(tmp_path, pth, "port_ver.h5")
    assert res["written"] == 4 and res["sca_overflow"] == 0
    printed = capsys.readouterr().out
    assert f"wrote 4 VER volumes to {out}" in printed
    assert "e2e: 4 volumes in" in printed

    ver = build_ver_config(load_config(CONFIG))
    got, ref = _read_all(out), _read_all(jout)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32
        assert got[k].shape == ref[k].shape == (
            ver.embed_dims, ver.bev_z, ver.bev_h, ver.bev_w)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=2e-5)

    # the synthetic inputs themselves are the JAX package's, byte for byte
    with h5py.File(os.path.join(root, "new_vit_base_patch16_197_imagenet"
                                ".hdf5"), "r") as a, \
            h5py.File(os.path.join(jroot, "new_vit_base_patch16_197_"
                                   "imagenet.hdf5"), "r") as b:
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k][:], b[k][:])
    for name in ("scanvp2cord.pkl", "mp3d_forall.pkl"):
        with open(os.path.join(root, name), "rb") as f:
            mine = pickle.load(f)
        with open(os.path.join(jroot, name), "rb") as f:
            theirs = pickle.load(f)
        if isinstance(mine, dict):
            assert mine.keys() == theirs.keys()
            for k in mine:
                np.testing.assert_array_equal(mine[k], theirs[k])
        else:
            assert [i["token"] for i in mine] == [i["token"] for i in theirs]
    for scan in os.listdir(os.path.join(root, "world2pixel")):
        with open(os.path.join(root, "world2pixel", scan)) as f, \
                open(os.path.join(jroot, "world2pixel", scan)) as g:
            assert f.read() == g.read()


def test_serial_and_pipelined_dumps_are_byte_identical(jax_run, tmp_path):
    _, pth, _, _ = jax_run
    _, a, _ = _port_cli(tmp_path, pth, "serial.h5", "--serial")
    _, b, _ = _port_cli(tmp_path, pth, "pipe.h5")
    va, vb = _read_all(a), _read_all(b)
    assert sorted(va) == sorted(vb) and len(va) == 4
    for k in va:
        assert va[k].tobytes() == vb[k].tobytes()


def test_existing_keys_are_replaced(tmp_path):
    from vln_ver_tpu_torch.data import make_synthetic_dataset
    ver = build_ver_config(load_config(CONFIG))
    root = str(tmp_path / "data")
    ann = make_synthetic_dataset(root, num_scans=1, viewpoints_per_scan=3,
                                 num_cams=ver.num_cams, feat_hw=ver.feat_h,
                                 feat_dim=ver.in_channels)
    dataset = MP3DDataset(ann, root, num_cams=ver.num_cams,
                          feat_hw=ver.feat_h)
    out = str(tmp_path / "ver.h5")
    with h5py.File(out, "w") as f:   # a stale volume under a live token
        f.create_dataset("scan000_vp001", data=np.zeros(3, np.float32))
    for seed in (0, 1):
        model = build_model(ver, "cpu", seed=seed)

        @torch.inference_mode()
        def bev_only(feats, w2p, shift):
            outs = model(feats, w2p, shift)
            return outs["bev_embed"], outs["sca_overflow"]

        res = dump_volumes(bev_only, dataset, ver, out, batch_size=2,
                           device="cpu")
        assert res["written"] == 3
    vols = _read_all(out)
    assert sorted(vols) == ["scan000_vp000", "scan000_vp001",
                            "scan000_vp002"]
    with torch.inference_mode():
        s = dataset[1]
        bev = build_model(ver, "cpu", seed=1)(
            torch.from_numpy(s["features"][None]),
            torch.from_numpy(s["world2pixel"][None]),
            torch.from_numpy(s["origin_shift"][None]))["bev_embed"]
    np.testing.assert_array_equal(
        vols["scan000_vp001"],
        bev[0].numpy().reshape(ver.bev_z, ver.bev_h, ver.bev_w,
                               ver.embed_dims).transpose(3, 0, 1, 2))
    dataset.close()


def test_unported_dump_options_raise(tmp_path):
    # a mesh dump whose batch the data ranks cannot split
    with pytest.raises(ValueError, match="not divisible"):
        dump_volumes(None, [], build_ver_config(load_config(CONFIG)),
                     str(tmp_path / "x.h5"), device="cpu", batch_size=3,
                     mesh=Mesh((2, 1), 0, 0))


@pytest.mark.parametrize("cast", ["int8", "bfloat16", "float32"])
def test_image_path_refuses_feature_casts(tmp_path, cast):
    """uint8 views are already the smallest exact upload: the image path
    takes no feature cast, with the JAX package's ValueError."""
    ver = build_ver_config(load_config(CONFIG))
    for dump, args in ((dump_volumes, (None, [], ver)),
                       (jax_dump_volumes, (None, None,
                                           jax_build_ver_config(
                                               jax_load_config(CONFIG)),
                                           []))):
        with pytest.raises(ValueError, match="feature-upload option"):
            dump(*args, str(tmp_path / "x.h5"), input_cast=cast,
                 input_key="images")
    assert not os.path.exists(tmp_path / "x.h5")


def test_cli_refuses_cuda_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_occ.main([CONFIG, "--device", "cuda", "--synthetic", "--out",
                      str(tmp_path / "x.h5")])
    assert not os.path.exists(tmp_path / "x.h5")


def test_cli_fails_fast_on_capacity(jax_run, tmp_path):
    """A capacity below a camera's visible count: the dump is written, and
    the CLI then exits nonzero, as tools/get_occ.py does; a capacity that
    covers every camera dumps what the dense lift dumps."""
    _, pth, jout, _ = jax_run
    with pytest.raises(SystemExit, match="sca_query_capacity overflow"):
        _port_cli(tmp_path, pth, "x.h5", "sca_query_capacity=1")
    _, out, res = _port_cli(tmp_path, pth, "cap.h5",
                            "sca_query_capacity=31")
    assert res["sca_overflow"] == 0
    got, ref = _read_all(out), _read_all(jout)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=2e-5)


def test_quantize_int8_is_jax_s():
    from vln_ver_tpu.ver_writer import quantize_int8 as jax_quantize
    from vln_ver_tpu_torch.ver_writer import quantize_int8
    rng = np.random.default_rng(0)
    f = (rng.standard_normal((2, 3, 4, 5, 6))
         * rng.uniform(0.1, 30.0, (1, 3, 1, 1, 6))).astype(np.float32)
    f[0, 0, :, :, 0] = 0.0                  # an all-zero slab
    (q, scale), (jq, jscale) = quantize_int8(f), jax_quantize(f)
    assert q.dtype == jq.dtype == np.int8
    assert scale.dtype == jscale.dtype == np.float32
    assert q.tobytes() == jq.tobytes() and scale.tobytes() == jscale.tobytes()


def _jax_dump_with(jax_run, tmp_path, **kw):
    """The JAX dump of jax_run's data and weights with dump options."""
    root, _, _, params = jax_run
    ver = jax_build_ver_config(jax_load_config(CONFIG))
    dataset = JaxMP3DDataset(os.path.join(root, "mp3d_forall.pkl"), root,
                             voxel_num=ver.voxel_num,
                             occupancy_classes=ver.occupancy_classes,
                             num_cams=ver.num_cams, feat_hw=ver.feat_h,
                             test_mode=True)
    model = JaxVoxelFormer(ver)

    @jax.jit
    def bev_only(p, feats, w2p, shift):
        outs = model.apply(p, feats, w2p, shift, only_bev=True)
        return outs["bev_embed"], outs["sca_overflow"]

    out = str(tmp_path / "jax_opt.h5")
    jax_dump_volumes(bev_only, {"params": params}, ver, dataset, out,
                     batch_size=3, serial=True, **kw)
    return out


@pytest.mark.parametrize("upload", ["int8", "bfloat16"])
def test_upload_dtype_matches_jax(jax_run, tmp_path, upload):
    """``--upload-dtype``: the port's dump against JAX's with the same
    upload (int8 quantised on the host and dequantised in fp32 on the
    device; bfloat16 rounded on the host), rtol 1e-4 / atol 2e-5; the
    pipelined dump is the serial one, byte for byte."""
    jout = _jax_dump_with(jax_run, tmp_path, input_cast=upload)
    _, pth, _, _ = jax_run
    _, out, res = _port_cli(tmp_path, pth, "up.h5", "--upload-dtype", upload)
    _, ser, _ = _port_cli(tmp_path, pth, "up_serial.h5", "--upload-dtype",
                          upload, "--serial")
    assert res["written"] == 4
    got, ref, serial = _read_all(out), _read_all(jout), _read_all(ser)
    assert sorted(got) == sorted(ref) == sorted(serial)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=2e-5)
        assert got[k].tobytes() == serial[k].tobytes()


# -- the fused image path ----------------------------------------------------

VIT_ARGS = ["--vit-patch-size", "8", "--vit-layers", "2", "--vit-heads", "4"]


@pytest.fixture(scope="module")
def jax_images(jax_run, tmp_path_factory):
    """JAX's fused image dump (uint8 views -> ViT -> lift in one jitted
    program) of its synthetic 'forall' split with 32 x 32 views, jax_run's
    VoxelFormer weights and a 2-layer ViT moved off its init, saved for
    the port in HF layout."""
    from vln_ver_tpu.models.vit import vit_feature_frontend, vit_for_ver
    from vln_ver_tpu_torch.convert.vit import vit_state_dict_from_jax

    _, pth, _, params = jax_run
    tmp = tmp_path_factory.mktemp("jax_img")
    ver = jax_build_ver_config(jax_load_config(CONFIG))
    root = str(tmp / "data")
    ann = jax_make_synthetic(root, split="forall", num_cams=ver.num_cams,
                             feat_hw=ver.feat_h, feat_dim=ver.in_channels,
                             occ_dims=(ver.occ_zdim, ver.occ_ydim,
                                       ver.occ_xdim), pc_range=ver.pc_range,
                             image_hw=(32, 32))
    vit = vit_for_ver(ver, patch_size=8, num_layers=2, num_heads=4)
    variables = vit.init(jax.random.PRNGKey(1), np.zeros((1, 32, 32, 3),
                                                         np.float32))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), variables)
    vit_pth = str(tmp / "vit.pth")
    torch.save(vit_state_dict_from_jax(variables), vit_pth)
    dataset = JaxMP3DDataset(ann, root, from_images=True,
                             voxel_num=ver.voxel_num,
                             occupancy_classes=ver.occupancy_classes,
                             num_cams=ver.num_cams, feat_hw=ver.feat_h,
                             test_mode=True)
    model = JaxVoxelFormer(ver)

    @jax.jit
    def bev_images(p, images, w2p, shift):
        feats = vit_feature_frontend(vit, p["vit"], images)
        outs = model.apply(p["ver"], feats, w2p, shift, only_bev=True)
        return outs["bev_embed"], outs["sca_overflow"]

    out = str(tmp / "jax_fused.h5")
    res = jax_dump_volumes(bev_images, {"ver": {"params": params},
                                        "vit": variables}, ver, dataset,
                           out, batch_size=3, serial=True,
                           input_key="images")
    assert res["written"] == 4
    return root, pth, vit_pth, out


def _port_fused(tmp_path, jax_images, name, *extra):
    _, pth, vit_pth, _ = jax_images
    return _port_cli(tmp_path, pth, name, "--from-images",
                     "--vit-checkpoint", vit_pth, *VIT_ARGS, *extra)


def test_fused_image_dump_matches_jax(jax_images, tmp_path):
    """``--from-images --synthetic`` on an empty root: the port writes the
    JAX generator's views byte for byte, and its fused dump is JAX's
    fused dump within rtol 1e-4 / atol 2e-5."""
    jroot, _, _, jout = jax_images
    root, out, res = _port_fused(tmp_path, jax_images, "fused.h5")
    assert res["written"] == 4 and res["sca_overflow"] == 0
    with h5py.File(os.path.join(root, "panorama_images.hdf5"), "r") as a, \
            h5py.File(os.path.join(jroot, "panorama_images.hdf5"),
                      "r") as b:
        assert sorted(a) == sorted(b) and len(a) == 8
        for k in b:
            assert a[k].dtype == b[k].dtype == np.uint8
            assert a[k].shape == (32, 32, 3)
            assert a[k][:].tobytes() == b[k][:].tobytes()
    got, ref = _read_all(out), _read_all(jout)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=2e-5)


def test_fused_dump_matches_two_stage(jax_images, tmp_path):
    """The fused dump against extract (``extract_vit_features`` into a
    feature store) then the feature dump, both in the port: rtol 1e-5 /
    atol 1e-5 (tests/test_from_images.py:112 holds JAX to the same)."""
    import shutil

    from vln_ver_tpu_torch import extract_vit_features
    _, pth, vit_pth, _ = jax_images
    root, fused, _ = _port_fused(tmp_path, jax_images, "fused.h5")
    two = str(tmp_path / "two_stage")
    shutil.copytree(root, two)
    os.remove(os.path.join(two, "new_vit_base_patch16_197_imagenet.hdf5"))
    extract_vit_features.main([
        "--images", os.path.join(root, "panorama_images.hdf5"), "--out",
        os.path.join(two, "new_vit_base_patch16_197_imagenet.hdf5"),
        "--checkpoint", vit_pth, "--image-size", "32", "--patch-size", "8",
        "--embed-dims", "32", "--num-layers", "2", "--num-heads", "4",
        "--ffn-dim", "128", "--device", "cpu"])
    out = str(tmp_path / "two_stage.h5")
    get_occ.main([CONFIG, "--device", "cpu", "--checkpoint", pth, "--out",
                  out, "--batch-size", "3", "--cfg-options",
                  f"data.test.data_root={two}",
                  f"data.test.ann_file={two}/mp3d_forall.pkl"])
    a, b = _read_all(fused), _read_all(out)
    assert sorted(a) == sorted(b) and len(a) == 4
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5)


def test_fused_path_refuses_a_missing_image_file(jax_images, tmp_path):
    """A custom ``--image-file`` is never regenerated, even under
    ``--synthetic``; without ``--synthetic`` a missing default one is not
    regenerated either."""
    with pytest.raises(FileNotFoundError, match="--from-images"):
        _port_fused(tmp_path, jax_images, "x.h5", "--image-file",
                    str(tmp_path / "none.hdf5"))
    jroot, pth, vit_pth, _ = jax_images
    root = str(tmp_path / "feats_only")
    get_occ.main([CONFIG, "--device", "cpu", "--synthetic", "--checkpoint",
                  pth, "--out", str(tmp_path / "f.h5"), "--cfg-options",
                  f"data.test.data_root={root}",
                  f"data.test.ann_file={root}/mp3d_forall.pkl"])
    with pytest.raises(FileNotFoundError, match="panorama_images"):
        get_occ.main([CONFIG, "--device", "cpu", "--checkpoint", pth,
                      "--from-images", "--vit-checkpoint", vit_pth,
                      *VIT_ARGS, "--out", str(tmp_path / "y.h5"),
                      "--cfg-options", f"data.test.data_root={root}",
                      f"data.test.ann_file={root}/mp3d_forall.pkl"])
