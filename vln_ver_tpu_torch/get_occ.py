"""VER volume generation — the product path (PyTorch port of
``tools/get_occ.py``).

Runs the voxel lift over the test split and writes each viewpoint's
(embed_dims, bev_z, bev_h, bev_w) voxel embedding into an HDF5 file with
``key = token``, gzip: the VER the downstream VLN agent consumes.

Usage:
  python -m vln_ver_tpu_torch.get_occ configs/verformer/get_occ.py \
      [--checkpoint X.pth] [--synthetic] [--limit N] [--batch-size B] \
      [--out F] [--gzip-level L] [--serial] [--device cuda|cpu] \
      [--upload-dtype auto|float32|bfloat16|int8] \
      [--from-images [--image-file F] [--vit-checkpoint V.pth] \
       [--hf-prefix P] [--vit-patch-size 16] [--vit-layers 12] \
       [--vit-heads 12]] [--cfg-options key=value ...]

``--checkpoint`` takes a reference-format ``.pth`` (what
``tools/export_voxelformer.py`` writes from a JAX checkpoint); without it
the weights are random from seed 0.  ``--from-images`` uploads the raw
uint8 views and runs the ViT frontend, the CLS strip and the lift in one
call on the card; ``--vit-checkpoint`` takes an HF ``ViTModel`` state dict,
and without it the ViT's weights are random from seed 1 (a smoke run
only).

Over several cards, one process each (torchrun's environment):
  torchrun --nproc-per-node N -m vln_ver_tpu_torch.get_occ CONFIG ... \
      --mesh D,V
splits the viewpoints over D data groups and each viewpoint's cameras over
V view ranks (``parallel.mesh``); view rank 0 of data group d writes
``<out>.shard<d>``.  ``--batch-size`` must divide by D.
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.get_occ")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   help="dotted config overrides: key.subkey=value")
    p.add_argument("--checkpoint", default=None,
                   help="reference-format .pth state_dict")
    p.add_argument("--synthetic", action="store_true",
                   help="generate synthetic inputs when the annotation "
                        "file (or, with --from-images, the image file) is "
                        "missing")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--out", default=None, help="override savename")
    p.add_argument("--gzip-level", type=int, default=4,
                   help="gzip level of the HDF5 datasets")
    p.add_argument("--upload-dtype", default="auto",
                   choices=["auto", "float32", "bfloat16", "int8"],
                   help="dtype of the feature upload: 'auto' = the model's "
                        "compute dtype where narrower than fp32; 'int8' "
                        "quantises per (sample, camera, channel) with "
                        "absmax scales and dequantises on the card (not "
                        "exact)")
    p.add_argument("--serial", action="store_true",
                   help="disable the pipelined dump (oracle path; output "
                        "bytes are identical either way)")
    p.add_argument("--from-images", action="store_true",
                   help="fused image->VER path: upload the uint8 views and "
                        "run the ViT frontend and the lift in one call")
    p.add_argument("--image-file", default=None,
                   help="images HDF5 ({scan}_{vp}_i{cam}_{deg} -> (H, W, 3)"
                        " uint8); default <data_root>/panorama_images.hdf5")
    p.add_argument("--vit-checkpoint", default=None,
                   help="HF ViTModel state dict of the frontend (omitted: "
                        "random weights, smoke only)")
    p.add_argument("--hf-prefix", default="",
                   help="ViT state-dict key prefix (e.g. 'vit.')")
    p.add_argument("--vit-patch-size", type=int, default=16)
    p.add_argument("--vit-layers", type=int, default=12)
    p.add_argument("--vit-heads", type=int, default=12)
    p.add_argument("--mesh", default=None,
                   help="'D[,V]': data x view process grid over the world "
                        "(torchrun); default D = the world, V = 1")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def make_bev_only(model, vit=None):
    """The dump's ``bev_only(inputs, w2p, shift) -> (bev_embed,
    sca_overflow)``, under ``inference_mode``: ``inputs`` are the ViT
    features, or with ``vit`` the uint8 views, which go through the ViT
    frontend (CLS stripped) into the lift in the same call."""
    from .models.vit import vit_feature_frontend

    @torch.inference_mode()
    def bev_only(inputs, w2p, shift):
        feats = inputs if vit is None else vit_feature_frontend(vit, inputs)
        outs = model(feats, w2p, shift, only_bev=True)
        return outs["bev_embed"], outs["sca_overflow"]

    return bev_only


def _images_missing(img_path: str, ann: str) -> bool:
    """Whether ``img_path`` is absent or lacks the first viewpoint of
    ``ann`` (synthetic splits share one root, and an earlier run may have
    written another split's images)."""
    if not os.path.exists(img_path):
        return True
    if not os.path.exists(ann):
        return False
    import h5py
    with open(ann, "rb") as f:
        infos = pickle.load(f)
    if not infos:
        return False
    scan, vp = infos[0]["token"].split("_")
    with h5py.File(img_path, "r") as f:
        return f"{scan}_{vp}_i1_0" not in f


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .config.api import (apply_cfg_options, build_ver_config,
                             dataset_kwargs, load_config)
    from .convert.voxelformer import load_checkpoint
    from .data.mp3d import MP3DDataset
    from .data.synthetic import make_synthetic_dataset
    from .models.detector import build_model
    from .parallel import multihost
    from .parallel.mesh import parse_eval_mesh, replicate
    from .runtime import resolve_device, set_fp32_precision
    from .ver_writer import dump_volumes

    device = multihost.initialize_if_needed(resolve_device(args.device))
    mesh = parse_eval_mesh(args.mesh)
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    ver = build_ver_config(cfg)
    set_fp32_precision(ver.dtype)
    savename = args.out or cfg.get("savename") or cfg.get(
        "model", {}).get("pts_bbox_head", {}).get("getbev")
    if not savename:
        raise ValueError("config has no savename/getbev and --out not given")
    os.makedirs(os.path.dirname(os.path.abspath(savename)), exist_ok=True)

    image_size = ver.feat_h * args.vit_patch_size
    ds_kw = dataset_kwargs(cfg, "test")
    ann, root = ds_kw["ann_file"], ds_kw["data_root"]
    # the JAX tool's rules: --from-images over a synthetic root whose image
    # file is missing, or lacks this split's keys, regenerates the 'forall'
    # split with images (same seed: every other artifact keeps its bytes);
    # a custom --image-file is never regenerated
    imgs_missing = False
    if args.from_images:
        img_path = args.image_file or os.path.join(
            root or "data/mp3d", "panorama_images.hdf5")
        imgs_missing = _images_missing(img_path, ann)
        if imgs_missing and (not args.synthetic or args.image_file):
            raise FileNotFoundError(
                f"--from-images: {img_path} is missing (or lacks this "
                "split's keys); extract the panorama views first or pass "
                "--image-file")
    if not os.path.exists(ann) or (args.synthetic and imgs_missing):
        if not args.synthetic:
            raise FileNotFoundError(ann)
        os.makedirs(root or "data/mp3d", exist_ok=True)
        ann = multihost.run_once(lambda: make_synthetic_dataset(
            root or "data/mp3d", split="forall", num_cams=ver.num_cams,
            feat_hw=ver.feat_h, feat_dim=ver.in_channels,
            occ_dims=(ver.occ_zdim, ver.occ_ydim, ver.occ_xdim),
            pc_range=ver.pc_range,
            image_hw=((image_size, image_size) if args.from_images
                      else None)))
    dataset = MP3DDataset(ann, root, num_cams=ver.num_cams,
                          feat_hw=ver.feat_h, voxel_num=ver.voxel_num,
                          occupancy_classes=ver.occupancy_classes,
                          test_mode=True, from_images=args.from_images,
                          image_file=args.image_file)

    model = build_model(ver, device, seed=0)
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint)
    vit = None
    if args.from_images:
        from .convert.vit import load_hf_vit_state_dict
        from .models.vit import vit_for_ver
        vit = vit_for_ver(ver, patch_size=args.vit_patch_size,
                          num_layers=args.vit_layers,
                          num_heads=args.vit_heads, dtype=ver.dtype)
        if args.vit_checkpoint:
            sd = torch.load(args.vit_checkpoint, map_location="cpu")
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
            load_hf_vit_state_dict(vit, sd, prefix=args.hf_prefix)
        else:
            print("[get_occ] no --vit-checkpoint: RANDOM ViT weights "
                  "(smoke only)")
            vit.init_weights(torch.Generator().manual_seed(1))
        vit = vit.to(device).eval()
    if mesh is not None:
        # rank 0's weights everywhere; each view rank lifts its cameras
        replicate(mesh, model).shard_views(mesh.views)
        if vit is not None:
            replicate(mesh, vit)
        if multihost.process_count() > 1:
            # one HDF5 file a data group (no concurrent writers)
            savename = f"{savename}.shard{mesh.data_index}"

    n = min(len(dataset), args.limit or len(dataset))
    try:
        res = dump_volumes(make_bev_only(model, vit), dataset, ver, savename,
                           batch_size=args.batch_size,
                           gzip_level=args.gzip_level, serial=args.serial,
                           indices=range(n), device=device,
                           input_cast=args.upload_dtype,
                           input_key=("images" if args.from_images
                                      else "features"), mesh=mesh)
    finally:
        dataset.close()
    print(f"wrote {res['written']} VER volumes to {savename}")
    print(f"e2e: {res['written']} volumes in {res['seconds']:.2f}s = "
          f"{res['volumes_per_sec']:.2f} volumes/s "
          f"(data load -> HDF5 bytes on disk)")
    if res["sca_overflow"] > 0:
        raise SystemExit(
            f"sca_query_capacity overflow: {res['sca_overflow']} visible "
            "queries beyond capacity in the worst camera slot — the "
            "dumped volumes are NOT exact. Validate with python -m "
            "vln_ver_tpu_torch.check_query_capacity and raise "
            "model.sca_query_capacity, then regenerate.")
    return res


if __name__ == "__main__":
    main()
