"""ViT-B/16 panorama feature extraction: raw views -> the reference's
``new_vit_base_patch16_197_imagenet.hdf5`` feature store (PyTorch port of
``tools/extract_vit_features.py``).

Each view goes through :func:`~vln_ver_tpu_torch.models.vit.preprocess_images`
and the port's :class:`~vln_ver_tpu_torch.models.vit.ViT` on the card, and
is written under its key ``{scan}_{vp}_i{cam}_{deg}`` as (1, 1 + P, C),
CLS first, gzip: the schema ``MP3DDataset`` (and the reference's own
loader) reads.

Image sources (``--images``):
  * a directory: files ``{scan}_{vp}_i{cam}_{deg}.{jpg,png,npy}`` (npy:
    (H, W, 3) uint8), searched recursively; two files with one key are
    refused before any work;
  * an HDF5 file of uint8 images under the same keys;
  * ``synthetic:N``: N random viewpoints x 6 views (the JAX tool's).

Weights (``--checkpoint``): an HF ``ViTModel`` state dict (``--hf-prefix
vit.`` for a classification checkpoint); without it the weights are
random (a smoke run only).

Usage:
  python -m vln_ver_tpu_torch.extract_vit_features --images views/ \
      --checkpoint vit_base_patch16_224.pth \
      --out new_vit_base_patch16_197_imagenet.hdf5 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np

KEY_RE = re.compile(r"^(?P<key>.+_i\d+_\d+)\.(jpg|jpeg|png|npy)$", re.I)


def iter_dir_images(root):
    """(key, path) of every image under ``root``, keys from the file
    names; a key found twice (one name in two directories, or x.jpg
    beside x.npy) is refused up front, not hours into a run."""
    by_key = {}
    for dirpath, _, names in sorted(os.walk(root)):
        for name in sorted(names):
            m = KEY_RE.match(name)
            if not m:
                continue
            key, path = m.group("key"), os.path.join(dirpath, name)
            if key in by_key:
                raise SystemExit(
                    f"duplicate feature key '{key}': {by_key[key]} "
                    f"and {path}; de-duplicate the image tree first")
            by_key[key] = path
    yield from by_key.items()


def load_image(path) -> np.ndarray:
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise SystemExit(f"PIL is needed for {path}; use .npy "
                             "images") from e
        img = np.asarray(Image.open(path).convert("RGB"))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: shape {img.shape}, want (H, W, 3)")
    return img.astype(np.uint8)


def iter_images(spec, image_hw):
    """(key, (H, W, 3) uint8) pairs from a directory, an HDF5 file or
    ``synthetic:N``."""
    if spec.startswith("synthetic:"):
        n = int(spec.split(":", 1)[1])
        rng = np.random.RandomState(0)
        for v in range(n):
            for deg in range(6):
                yield (f"scan{v:03d}_vp{v:03d}_i1_{deg}",
                       rng.randint(0, 256, (*image_hw, 3), np.uint8))
    elif os.path.isdir(spec):
        for key, path in iter_dir_images(spec):
            yield key, load_image(path)
    else:
        import h5py
        with h5py.File(spec, "r") as f:
            for key in sorted(f.keys()):
                yield key, np.asarray(f[key], np.uint8)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.extract_vit_features",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", required=True,
                    help="image dir | images HDF5 | synthetic:N")
    ap.add_argument("--out", required=True, help="output feature HDF5")
    ap.add_argument("--checkpoint", default=None,
                    help="HF ViTModel torch state dict (.pth/.bin)")
    ap.add_argument("--hf-prefix", default="",
                    help="state-dict key prefix (e.g. 'vit.')")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--patch-size", type=int, default=16)
    ap.add_argument("--embed-dims", type=int, default=768)
    ap.add_argument("--num-layers", type=int, default=12)
    ap.add_argument("--num-heads", type=int, default=12)
    ap.add_argument("--ffn-dim", type=int, default=3072)
    ap.add_argument("--mean", type=float, default=0.5,
                    help="normalisation mean (timm/HF ViT-B/16: 0.5)")
    ap.add_argument("--std", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (fp32 parameters and outputs)")
    ap.add_argument("--store-dtype", default="float32",
                    choices=["float32", "float16"])
    ap.add_argument("--input-hw", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="shape every view is brought to on the host, by "
                         "nearest sampling, before the ViT's own resize "
                         "(default: image-size)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import h5py
    import torch

    from .convert.vit import load_hf_vit_state_dict
    from .models.vit import ViT, preprocess_images
    from .runtime import resolve_device

    device = resolve_device(args.device)
    model = ViT(image_size=args.image_size, patch_size=args.patch_size,
                embed_dims=args.embed_dims, num_layers=args.num_layers,
                num_heads=args.num_heads, ffn_dim=args.ffn_dim,
                dtype=torch.bfloat16 if args.bf16 else torch.float32)
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu")
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        load_hf_vit_state_dict(model, sd, prefix=args.hf_prefix)
    else:
        print("[extract_vit] no --checkpoint: RANDOM weights (smoke only)")
        model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    in_hw = (tuple(args.input_hw) if args.input_hw
             else (args.image_size, args.image_size))
    store_dtype = np.dtype(args.store_dtype)
    keys, buf = [], []
    n_done = 0

    @torch.inference_mode()
    def forward(batch_u8):
        x = preprocess_images(torch.from_numpy(batch_u8).to(device),
                              args.image_size, args.mean, args.std)
        return model(x).cpu().numpy()

    def flush(fout):
        nonlocal n_done
        if not keys:
            return
        feats = forward(np.stack(buf))
        for k, ft in zip(keys, feats):
            fout.create_dataset(k, data=ft[None].astype(store_dtype),
                                compression="gzip")
        n_done += len(keys)
        keys.clear()
        buf.clear()

    with h5py.File(args.out, "w") as fout:
        for key, img in iter_images(args.images, in_hw):
            if img.shape[:2] != in_hw:
                # nearest sampling on the host to the one batch shape
                ys = np.arange(in_hw[0]) * img.shape[0] // in_hw[0]
                xs = np.arange(in_hw[1]) * img.shape[1] // in_hw[1]
                img = img[ys][:, xs]
            keys.append(key)
            buf.append(img)
            if len(keys) == args.batch:
                flush(fout)
        flush(fout)
    print(f"[extract_vit] wrote {n_done} views -> {args.out} "
          f"(tokens 1+{model.num_patches}, dim {args.embed_dims})")
    return n_done


if __name__ == "__main__":
    main()
