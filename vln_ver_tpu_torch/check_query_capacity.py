"""Validate ``sca_query_capacity`` against a dataset (the port's copy of
``tools/check_query_capacity.py``).

The capacity-bounded sparse lift (``sca_query_capacity`` K > 0) is exact
only where no camera sees more than K voxel queries; beyond K the
highest-index visible queries are dropped.  This scans every sample's
camera matrices on the host (numpy, no device work, no feature reads) and
reports the largest per-camera visible-query count, the least safe
capacity, and a padded recommendation.

Usage:
  python -m vln_ver_tpu_torch.check_query_capacity \
      configs/verformer/vocc.py [--synthetic] [--limit N] \
      [--capacity 256] [--split train|val|test] [--cfg-options k=v ...]

The exit status is 1 when ``--capacity`` is given and too small, so it can
gate a training or dump script.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.check_query_capacity")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--capacity", type=int, default=None,
                   help="candidate sca_query_capacity to validate")
    p.add_argument("--split", default="train",
                   choices=["train", "val", "test"])
    args = p.parse_args(argv)

    from . import geometry
    from .config.api import (apply_cfg_options, build_ver_config,
                             dataset_kwargs, load_config)
    from .data.mp3d import MP3DDataset
    from .data.synthetic import make_synthetic_dataset

    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    ver = build_ver_config(cfg)
    ds_kw = (dataset_kwargs(cfg, args.split)
             or dataset_kwargs(cfg, "train"))
    ann, root = ds_kw["ann_file"], ds_kw["data_root"]
    if not os.path.exists(ann):
        if not args.synthetic:
            raise FileNotFoundError(ann)
        os.makedirs(root or "data/mp3d", exist_ok=True)
        ann = make_synthetic_dataset(root or "data/mp3d", split=args.split,
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

    n = len(dataset) if args.limit is None else min(args.limit,
                                                    len(dataset))
    worst, worst_i = 0, -1
    for i in range(n):
        w2p, shift = dataset.cameras(i)
        need = geometry.max_visible_queries(
            w2p[None], shift[None], ver.bev_z, ver.bev_h, ver.bev_w,
            ver.pc_range)
        if need > worst:
            worst, worst_i = need, i
    # the next multiple of 64 above the worst count, plus one tile of
    # slack for unseen viewpoints of the same rig
    pad = -(-worst // 64) * 64 + 64
    print(f"samples scanned: {n}; voxel queries: {ver.bev_num}; "
          f"max visible per camera: {worst} (sample {worst_i})")
    print(f"minimum safe sca_query_capacity: {worst}; "
          f"recommended (padded): {min(pad, ver.bev_num)}")
    if args.capacity is not None:
        if args.capacity < worst:
            print(f"CAPACITY {args.capacity} INSUFFICIENT (< {worst})")
            return 1
        print(f"capacity {args.capacity} ok (>= {worst})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
