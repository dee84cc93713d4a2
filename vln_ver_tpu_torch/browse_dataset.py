"""Inspect dataset samples as the model sees them (PyTorch port of
``tools/browse_dataset.py``, the reference's tools/misc/browse_dataset.py).

    python -m vln_ver_tpu_torch.browse_dataset configs/verformer/vocc_tiny.py
        [--synthetic] [--split train] [--limit 8] [--save-occ DIR]
        [--cfg-options key=value ...] [--device cuda|cpu]

Prints one line a sample: token, feature statistics, ground-truth boxes
with their class names, occupancy fill.  ``--save-occ`` also writes a
top-down PNG of each occupancy grid (the class of the highest occupied
voxel; matplotlib is imported only then).  ``--synthetic`` writes the
JAX tool's synthetic dataset where the annotation file is missing.  The
samples are read on the host: ``--device`` is taken as every CLI of the
port takes it, and only checked.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.browse_dataset")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--limit", type=int, default=8)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--save-occ", default=None,
                   help="directory for occupancy slice PNGs")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def topdown(occ: np.ndarray, ver) -> np.ndarray:
    """(occ_ydim, occ_xdim) class of the highest occupied voxel of each
    column, -1 where the column is empty."""
    grid = occ.reshape(ver.occ_zdim, ver.occ_ydim, ver.occ_xdim)
    occ_mask = grid < ver.occupancy_classes
    first = occ_mask[::-1].argmax(0)
    cls = np.take_along_axis(grid[::-1], first[None], 0)[0]
    return np.where(occ_mask.any(0), cls, -1)


def main(argv=None) -> list:
    """Prints the summaries; returns them."""
    args = parse_args(argv)
    from .config.api import (apply_cfg_options, build_ver_config,
                             dataset_kwargs, load_config)
    from .data.mp3d import MP3DDataset
    from .data.synthetic import make_synthetic_dataset
    from .runtime import resolve_device

    resolve_device(args.device)
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    ver = build_ver_config(cfg)
    ds_kw = dataset_kwargs(cfg, args.split) or dataset_kwargs(cfg, "train")
    ann, root = ds_kw["ann_file"], ds_kw["data_root"]
    if not os.path.exists(ann):
        if not args.synthetic:
            raise FileNotFoundError(
                f"{ann} not found; pass --synthetic to generate data")
        os.makedirs(root or "data/mp3d", exist_ok=True)
        ann = make_synthetic_dataset(
            root or "data/mp3d", num_scans=2, viewpoints_per_scan=4,
            num_cams=ver.num_cams, feat_hw=ver.feat_h,
            feat_dim=ver.in_channels,
            occ_dims=(ver.occ_zdim, ver.occ_ydim, ver.occ_xdim),
            pc_range=ver.pc_range)
    ds = MP3DDataset(ann, root, voxel_num=ver.voxel_num,
                     occupancy_classes=ver.occupancy_classes,
                     num_cams=ver.num_cams, feat_hw=ver.feat_h,
                     test_mode=ds_kw.get("test_mode", False))
    classes = tuple(ds_kw.get("classes", ()) or cfg.get("class_names", ()))
    print(f"dataset: {len(ds)} samples, classes={len(classes)}, "
          f"occ classes={ver.occupancy_classes}")
    lines = []
    try:
        for i in range(min(args.limit, len(ds))):
            s = ds[i]
            feats, occ = s["features"], s["occ_dense"]
            occupied = occ < ver.occupancy_classes
            valid = np.asarray(s["gt_valid"], bool)
            n_gt = int(valid.sum())
            labels = np.asarray(s["gt_labels"])[valid]
            names = [classes[int(c)] if int(c) < len(classes) else str(c)
                     for c in labels[:6]]
            line = (f"[{i}] {s['token']}: feats{tuple(feats.shape)} "
                    f"mean={feats.mean():+.3f} std={feats.std():.3f} | "
                    f"gt boxes={n_gt} ({', '.join(names)}"
                    f"{', ...' if n_gt > 6 else ''}) | "
                    f"occ fill={occupied.mean() * 100:.2f}% "
                    f"({int(occupied.sum())} voxels)")
            print(line)
            lines.append(line)
            if args.save_occ:
                os.makedirs(args.save_occ, exist_ok=True)
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                plt.figure(figsize=(4, 4))
                plt.imshow(topdown(occ, ver), cmap="tab20",
                           interpolation="nearest")
                plt.title(s["token"])
                out = os.path.join(args.save_occ,
                                   f"{s['token']}_topdown.png")
                plt.savefig(out, dpi=120)
                plt.close()
                print(f"    wrote {out}")
    finally:
        ds.close()
    return lines


if __name__ == "__main__":
    main()
