"""VER volume generation — the product path (PyTorch port of
``tools/get_occ.py``).

Runs the voxel lift over the test split and writes each viewpoint's
(embed_dims, bev_z, bev_h, bev_w) voxel embedding into an HDF5 file with
``key = token``, gzip: the VER the downstream VLN agent consumes.

Usage:
  python -m vln_ver_tpu_torch.get_occ configs/verformer/get_occ.py \
      [--checkpoint X.pth] [--synthetic] [--limit N] [--batch-size B] \
      [--out F] [--gzip-level L] [--serial] [--device cuda|cpu] \
      [--cfg-options key=value ...]

``--checkpoint`` takes a reference-format ``.pth`` (what
``tools/export_voxelformer.py`` writes from a JAX checkpoint); without it
the weights are random from seed 0.
"""

from __future__ import annotations

import argparse
import os

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
                        "file is missing")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--out", default=None, help="override savename")
    p.add_argument("--gzip-level", type=int, default=4,
                   help="gzip level of the HDF5 datasets")
    p.add_argument("--serial", action="store_true",
                   help="disable the pipelined dump (oracle path; output "
                        "bytes are identical either way)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .config.api import (apply_cfg_options, build_ver_config,
                             dataset_kwargs, load_config)
    from .convert.voxelformer import load_checkpoint
    from .data.mp3d import MP3DDataset
    from .data.synthetic import make_synthetic_dataset
    from .models.detector import build_model
    from .runtime import resolve_device, set_fp32_precision
    from .ver_writer import dump_volumes

    device = resolve_device(args.device)
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    ver = build_ver_config(cfg)
    set_fp32_precision(ver.dtype)
    savename = args.out or cfg.get("savename") or cfg.get(
        "model", {}).get("pts_bbox_head", {}).get("getbev")
    if not savename:
        raise ValueError("config has no savename/getbev and --out not given")
    os.makedirs(os.path.dirname(os.path.abspath(savename)), exist_ok=True)

    ds_kw = dataset_kwargs(cfg, "test")
    ann, root = ds_kw["ann_file"], ds_kw["data_root"]
    if not os.path.exists(ann):
        if not args.synthetic:
            raise FileNotFoundError(ann)
        os.makedirs(root or "data/mp3d", exist_ok=True)
        ann = make_synthetic_dataset(root or "data/mp3d", split="forall",
                                     num_cams=ver.num_cams,
                                     feat_hw=ver.feat_h,
                                     feat_dim=ver.in_channels,
                                     occ_dims=(ver.occ_zdim, ver.occ_ydim,
                                               ver.occ_xdim),
                                     pc_range=ver.pc_range)
    dataset = MP3DDataset(ann, root, num_cams=ver.num_cams,
                          feat_hw=ver.feat_h, voxel_num=ver.voxel_num,
                          occupancy_classes=ver.occupancy_classes,
                          test_mode=True)

    model = build_model(ver, device, seed=0)
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint)

    @torch.inference_mode()
    def bev_only(feats, w2p, shift):
        outs = model(feats, w2p, shift, only_bev=True)
        return outs["bev_embed"], outs["sca_overflow"]

    n = min(len(dataset), args.limit or len(dataset))
    try:
        res = dump_volumes(bev_only, dataset, ver, savename,
                           batch_size=args.batch_size,
                           gzip_level=args.gzip_level, serial=args.serial,
                           indices=range(n), device=device)
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
            "dumped volumes are NOT exact.")
    return res


if __name__ == "__main__":
    main()
