"""Evaluation CLI: occupancy SSC metrics and indoor 3D detection mAP
(PyTorch port of ``tools/test.py``).

Usage:
  python -m vln_ver_tpu_torch.test configs/verformer/vocc.py \
      [--checkpoint model.pth] [--synthetic] [--limit N] \
      [--batch-size B] [--occ-thresholds T ...] [--device cuda|cpu] \
      [--cfg-options key=value ...]

``--checkpoint`` takes a reference-format ``.pth`` (what
``tools/export_voxelformer.py`` writes from a JAX checkpoint), a train
step directory, or a train checkpoint directory (``<work-dir>/ckpt`` of
``python -m vln_ver_tpu_torch.train``), whose latest completed step is
read; without it the weights are random from seed 0.  ``--synthetic``
writes a synthetic test split where the annotation file is missing.
Prints the metric keys of ``tools/test.py`` (``mAP_*``, ``mAR_*``,
``miou``, ``iou``, ``occ_precision``, ``occ_recall``) and fails on a
capacity overflow.

Over several cards, one process each (torchrun's environment):
  torchrun --nproc-per-node N -m vln_ver_tpu_torch.test CONFIG ... \
      --mesh D[,V]
splits the split over D data groups (``--batch-size`` must divide by D)
and each viewpoint's cameras over V; every rank prints the metrics of the
whole split (``evaluation.runner.evaluate_model``).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.test")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   help="dotted config overrides: key.subkey=value")
    p.add_argument("--checkpoint", default=None,
                   help="reference-format .pth state_dict, or a train "
                        "checkpoint directory (its latest step); random "
                        "weights from seed 0 if omitted")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic test split when the "
                        "annotation file is missing")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--occ-thresholds", type=float, nargs="+",
                   default=[0.25])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--mesh", type=str, default=None,
                   help="'D[,V]': data x view process grid over the world "
                        "(torchrun); default D = the world, V = 1")
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
    from .evaluation.runner import evaluate_model
    from .models.detector import build_model
    from .parallel import multihost
    from .parallel.mesh import parse_eval_mesh, replicate
    from .runtime import resolve_device, set_fp32_precision
    from .utils.checkpoint import model_file

    device = multihost.initialize_if_needed(resolve_device(args.device))
    mesh = parse_eval_mesh(args.mesh)
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    ver = build_ver_config(cfg)
    set_fp32_precision(ver.dtype)

    ds_kw = dataset_kwargs(cfg, "test") or dataset_kwargs(cfg, "val")
    ann, root = ds_kw["ann_file"], ds_kw["data_root"]
    if not os.path.exists(ann):
        if not args.synthetic:
            raise FileNotFoundError(ann)
        os.makedirs(root or "data/mp3d", exist_ok=True)
        ann = multihost.run_once(lambda: make_synthetic_dataset(
            root or "data/mp3d", split="test", num_cams=ver.num_cams,
            feat_hw=ver.feat_h, feat_dim=ver.in_channels,
            occ_dims=(ver.occ_zdim, ver.occ_ydim, ver.occ_xdim),
            pc_range=ver.pc_range))
    dataset = MP3DDataset(ann, root, num_cams=ver.num_cams,
                          feat_hw=ver.feat_h, voxel_num=ver.voxel_num,
                          occupancy_classes=ver.occupancy_classes,
                          test_mode=False)

    model = build_model(ver, device, seed=0)
    if args.checkpoint:
        load_checkpoint(model, model_file(args.checkpoint))
    if mesh is not None:
        replicate(mesh, model)
    try:
        metrics = evaluate_model(model, dataset,
                                 occ_thresholds=tuple(args.occ_thresholds),
                                 limit=args.limit,
                                 batch_size=args.batch_size,
                                 classes=tuple(ds_kw.get("classes", ())),
                                 mesh=mesh)
    finally:
        dataset.close()
    for k in sorted(metrics):
        if k.startswith(("mAP", "mAR")):
            print(f"{k}: {metrics[k]:.4f}")
    for k in sorted(metrics):
        if k.startswith(("miou", "iou", "occ_")):
            print(f"{k}: {metrics[k]:.4f}")
    if metrics.get("sca_overflow", 0) > 0:
        raise SystemExit(
            f"sca_query_capacity overflow: {int(metrics['sca_overflow'])} "
            "visible queries beyond capacity in the worst camera slot: the "
            "metrics above are NOT exact.")
    return metrics


if __name__ == "__main__":
    main()
