"""The port's ViT frontend against the JAX package's, fp32 on the CPU: the
ViT with the JAX ViT's weights carried across (2 layers, hidden 32, 4
heads, 32 x 32 images, patch 8; atol 2e-5), the preprocessing (native,
downscale, upscale; atol 1e-6), the HF state-dict loader against
``transformers.ViTModel`` (atol 2e-5) and the feature extractor's HDF5
store against ``tools/extract_vit_features.py`` on the same images and
weights (atol 2e-5)."""

import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_ver_tpu.models.vit import ViT as JaxViT
from vln_ver_tpu.models.vit import preprocess_images as jax_preprocess
from vln_ver_tpu.models.vit import vit_feature_frontend as jax_frontend
from vln_ver_tpu_torch import extract_vit_features
from vln_ver_tpu_torch.convert.vit import (load_hf_vit_state_dict,
                                           vit_state_dict_from_jax)
from vln_ver_tpu_torch.models.vit import (ViT, preprocess_images,
                                          vit_feature_frontend)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, PATCH, HIDDEN, LAYERS, HEADS, FFN = 32, 8, 32, 2, 4, 64


def _jax_vit():
    return JaxViT(image_size=SIZE, patch_size=PATCH, embed_dims=HIDDEN,
                  num_layers=LAYERS, num_heads=HEADS, ffn_dim=FFN)


@pytest.fixture(scope="module")
def weights():
    """JAX ViT variables, moved off the flax init (zero biases and unit
    LayerNorms would leave their mapping untested), and the port's ViT
    holding them."""
    variables = _jax_vit().init(jax.random.PRNGKey(3),
                                jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), variables)
    model = ViT(SIZE, PATCH, HIDDEN, LAYERS, HEADS, FFN).eval()
    model.load_state_dict(vit_state_dict_from_jax(variables), strict=True)
    return variables, model


def test_vit_matches_jax(weights):
    variables, model = weights
    x = np.random.default_rng(1).standard_normal(
        (3, SIZE, SIZE, 3)).astype(np.float32)
    ref = np.asarray(_jax_vit().apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (3, 1 + (SIZE // PATCH) ** 2, HIDDEN)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)


def test_feature_frontend_matches_jax(weights):
    """uint8 views (B, cams, H, W, 3) -> (B, cams, fh, fw, C), CLS
    stripped, through a resize (40 x 48 views)."""
    variables, model = weights
    imgs = np.random.default_rng(2).integers(
        0, 256, (2, 3, 40, 48, 3)).astype(np.uint8)
    ref = np.asarray(jax_frontend(_jax_vit(), variables, jnp.asarray(imgs)))
    with torch.inference_mode():
        got = vit_feature_frontend(model, torch.from_numpy(imgs))
    assert got.shape == ref.shape == (2, 3, 4, 4, HIDDEN)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("hw,size", [((224, 224), 224),   # native: no resize
                                     ((48, 40), 32),      # downscale
                                     ((20, 24), 32),      # upscale
                                     ((17, 33), 32)])     # one of each
def test_preprocess_matches_jax(hw, size):
    imgs = np.random.default_rng(sum(hw)).integers(
        0, 256, (2, *hw, 3)).astype(np.uint8)
    ref = np.asarray(jax_preprocess(jnp.asarray(imgs), size))
    got = preprocess_images(torch.from_numpy(imgs), size)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_preprocess_matches_jax_on_a_large_downscale():
    """300 x 500 -> 224.  Each output's triangle weights follow from its
    sample position in the input, (i + 0.5) / scale - 0.5, up to 499.6
    here, where one fp32 ulp is 3.05e-5 of a pixel, and torch's filter
    and JAX's compiled resize round them apart (JAX's compiled 300 -> 224
    weights differ from its own ``compute_weight_mat`` run eagerly by up
    to 7.7e-6).  A weight moves by the
    position's error over the kernel width (1.34 and 2.23 input pixels),
    and a normalised value, in [-1, 1], by twice that: 2 x 3.05e-5 / 1.34
    = 4.6e-5 bounds one ulp of position in both axes."""
    imgs = np.random.default_rng(800).integers(
        0, 256, (2, 300, 500, 3)).astype(np.uint8)
    ref = np.asarray(jax_preprocess(jnp.asarray(imgs), 224))
    got = preprocess_images(torch.from_numpy(imgs), 224)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=4.6e-5)


def test_vit_refuses_the_wrong_image_size(weights):
    _, model = weights
    with pytest.raises(ValueError, match="takes 32x32"):
        model(torch.zeros(1, 48, 48, 3))


@pytest.mark.parametrize("prefix", ["", "vit."])
def test_hf_state_dict_matches_transformers(prefix):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ViTConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN, image_size=SIZE,
        patch_size=PATCH, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(len(prefix))
    hf = transformers.ViTModel(cfg, add_pooling_layer=True).eval()
    x = np.random.default_rng(4).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(
            x.transpose(0, 3, 1, 2))).last_hidden_state.numpy()
    sd = {prefix + k: v for k, v in hf.state_dict().items()}
    if prefix:                      # a classification checkpoint's head
        sd["classifier.weight"] = torch.zeros(3, HIDDEN)
    model = ViT(SIZE, PATCH, HIDDEN, LAYERS, HEADS, FFN).eval()
    unused = load_hf_vit_state_dict(model, sd, prefix=prefix)
    assert all(k.startswith((prefix + "pooler.", "classifier."))
               for k in unused) and unused
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def _hf_layout_checkpoint(tmp_path, weights):
    """The JAX ViT's weights as an HF-layout ``.pth`` that both extractors
    load (the port's ViT names are HF's)."""
    variables, _ = weights
    path = str(tmp_path / "vit.pth")
    torch.save({"vit." + k: v for k, v in
                vit_state_dict_from_jax(variables).items()}, path)
    return path


def test_extractor_matches_jax_extractor(weights, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import extract_vit_features as jax_cli

    imgdir = tmp_path / "views"
    imgdir.mkdir()
    rng = np.random.default_rng(5)
    for v in range(2):
        for deg in range(3):
            np.save(imgdir / f"sA_vp{v}_i1_{deg}.npy",
                    rng.integers(0, 256, (40, 48, 3)).astype(np.uint8))
    ckpt = _hf_layout_checkpoint(tmp_path, weights)
    common = ["--images", str(imgdir), "--checkpoint", ckpt,
              "--hf-prefix", "vit.", "--image-size", str(SIZE),
              "--patch-size", str(PATCH), "--embed-dims", str(HIDDEN),
              "--num-layers", str(LAYERS), "--num-heads", str(HEADS),
              "--ffn-dim", str(FFN), "--batch", "4", "--input-hw", "40",
              "48"]
    jout, out = str(tmp_path / "jax.hdf5"), str(tmp_path / "port.hdf5")
    jax_cli.main(common + ["--out", jout])
    extract_vit_features.main(common + ["--out", out, "--device", "cpu"])
    with h5py.File(out, "r") as f, h5py.File(jout, "r") as g:
        assert sorted(f) == sorted(g) == [f"sA_vp{v}_i1_{d}"
                                          for v in range(2)
                                          for d in range(3)]
        for k in g:
            assert f[k].shape == g[k].shape == (1, 1 + (SIZE // PATCH) ** 2,
                                                HIDDEN)
            assert f[k].dtype == g[k].dtype == np.float32
            assert f[k].compression == "gzip"
            np.testing.assert_allclose(f[k][:], g[k][:], rtol=0, atol=2e-5)


def test_extractor_synthetic_store_dtype_and_refusals(tmp_path):
    out = str(tmp_path / "f16.hdf5")
    small = ["--image-size", "16", "--patch-size", "8", "--embed-dims",
             "8", "--num-layers", "1", "--num-heads", "2", "--ffn-dim",
             "16", "--batch", "5", "--device", "cpu"]
    extract_vit_features.main(["--images", "synthetic:2", "--out", out,
                               "--store-dtype", "float16", *small])
    with h5py.File(out, "r") as f:
        assert len(f) == 12 and sorted(f)[0] == "scan000_vp000_i1_0"
        assert f["scan001_vp001_i1_5"].shape == (1, 5, 8)
        assert f["scan001_vp001_i1_5"].dtype == np.float16
    # two files under one key: refused before any work
    dup = tmp_path / "dup"
    (dup / "a").mkdir(parents=True)
    (dup / "b").mkdir()
    for sub in ("a", "b"):
        np.save(dup / sub / "s_v_i1_0.npy", np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(SystemExit, match="duplicate feature key"):
        extract_vit_features.main(["--images", str(dup), "--out",
                                   str(tmp_path / "x.hdf5"), *small])
