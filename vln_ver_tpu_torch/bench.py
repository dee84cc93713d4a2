"""The repo's headline measurement on one card: VER volumes/s over 36
views (PyTorch port of the root ``bench.py``).

    python -m vln_ver_tpu_torch.bench [--batch 8] [--alt-batch 4]
        [--iters 8] [--repeats 5] [--qcap N] [--e2e-volumes 32]
        [--e2e-passes 2] [--upload auto|float32|bfloat16|int8]
        [--no-e2e] [--no-images] [--data-dir D] [--device cuda|cpu]

Measures ``ver_volumes_per_sec_per_chip_36view``: the full get_occ forward
(the lift, the DETR decoder and the occupancy head) of
``VERConfig(num_cams=36, dtype=bfloat16)`` with random weights from seed
0, on ``example_inputs`` (numpy seed 0, 70 degree pinholes at yaw 10
degrees times the camera index, zero shift), at ``--batch`` with
``--alt-batch`` beside it.  The lift is the capacity-bounded sparse one at
the capacity the rig needs (:func:`derived_qcap`: 176 visible queries,
rounded up to 192), unless ``--qcap`` pins one (``--qcap 0``: the dense
lift).  Each rate is the least of ``--repeats`` samples of ``--iters``
back-to-back warm forwards between CUDA events
(``utils.bench.event_time_stats``), with their spread.

Then the product path, as ``get_occ`` runs it, on a 36-camera synthetic
dataset of ``--e2e-volumes`` viewpoints under ``--data-dir``: the
pipelined HDF5 dump (``ver_writer.dump_volumes``; one untimed pass, then
``--e2e-passes`` timed ones, their median and every rate), and the fused
image path (uint8 views through a bf16 ViT-B/16 with random weights from
seed 1 into the lift, ``get_occ.make_bev_only``).  Both read and write
HDF5: without ``h5py`` they exit nonzero unless ``--no-e2e`` is given.

Prints ONE JSON line with the JAX harness's keys, less ``vs_baseline``
(its baselines are TPU readings), plus ``card`` (name and power limit)
and ``peak_mib``.  Exits nonzero when the sparse lift overflowed its
capacity, as ``get_occ`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

METRIC = "ver_volumes_per_sec_per_chip_36view"
NUM_CAMS = 36
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.bench")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--alt-batch", type=int, default=4,
                   help="second operating point in the same line (0: none)")
    p.add_argument("--iters", type=int, default=8,
                   help="back-to-back forwards in each timed sample")
    p.add_argument("--repeats", type=int, default=5,
                   help="timed samples of each rate")
    p.add_argument("--qcap", type=int, default=None,
                   help="sca_query_capacity; default: derived from the rig; "
                        "0: the dense lift")
    p.add_argument("--e2e-volumes", type=int, default=32)
    p.add_argument("--e2e-passes", type=int, default=2)
    p.add_argument("--upload", default="auto",
                   choices=["auto", "float32", "bfloat16", "int8"],
                   help="the e2e dump's feature upload (int8 is not exact)")
    p.add_argument("--no-e2e", action="store_true",
                   help="only the forward rates (no HDF5 legs)")
    p.add_argument("--no-images", action="store_true",
                   help="skip the fused image leg")
    p.add_argument("--data-dir", default=os.path.join(REPO, ".bench_data"),
                   help="where the e2e legs' synthetic datasets live")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def example_inputs(cfg, batch: int = 1, seed: int = 0):
    """(features, world2pixel, origin_shift) as numpy fp32: standard-normal
    features from ``default_rng(seed)``, a 70 degree pinhole at yaw
    ``360 / num_cams * i`` for camera i at the origin, zero shift (the
    JAX package's ``__graft_entry__._example_inputs``, bit for bit)."""
    from .geometry import make_pinhole_world2pixel

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (batch, cfg.num_cams, cfg.feat_h, cfg.feat_w, cfg.in_channels)
    ).astype(np.float32)
    w2p = np.stack([
        np.stack([make_pinhole_world2pixel(
            70.0, (360.0 / cfg.num_cams) * i, (0.0, 0.0, 0.0))
            for i in range(cfg.num_cams)])
        for _ in range(batch)]).astype(np.float32)
    return feats, w2p, np.zeros((batch, 3), np.float32)


def derived_qcap(cfg, w2p, shift) -> int:
    """The sparse lift's capacity taken from the rig: the host bound on the
    visible queries of the worst camera (``geometry.max_visible_queries``,
    never an under-count) rounded up to a multiple of 64, at most every
    query (the root ``bench.py``'s ``_derived_qcap``)."""
    from .geometry import max_visible_queries

    need = max_visible_queries(np.asarray(w2p), np.asarray(shift), cfg.bev_z,
                               cfg.bev_h, cfg.bev_w, cfg.pc_range)
    return min(int(-(-need // 64) * 64), cfg.bev_num)


def forward_rate(model, cfg, batch: int, device, iters: int, repeats: int,
                 warmup: int = 3):
    """(volumes/s, timing stats, sca_overflow) of the full forward at
    ``batch`` on ``example_inputs``, the inputs on ``device`` before the
    timing."""
    from .utils.bench import event_time_stats, full_forward_step

    ins = [torch.from_numpy(a).to(device)
           for a in example_inputs(cfg, batch=batch)]
    step = full_forward_step(model)
    with torch.inference_mode():
        overflow = int(model(*ins, only_bev=True)["sca_overflow"])
    stats = event_time_stats(lambda: step(*ins), device, iters,
                             warmup=warmup, repeats=repeats)
    return batch / stats["sec_per_iter"], stats, overflow


def e2e_dataset(cfg, n_volumes: int, root: str, images: bool):
    """The synthetic 36-camera dataset of the e2e legs under ``root``
    (written once, then reused: the generator's ``mp3d_forall.pkl``
    marks it), with the raw uint8 views too when ``images``."""
    from .data.synthetic import make_synthetic_dataset

    ann = os.path.join(root, "mp3d_forall.pkl")
    if not os.path.exists(ann):
        os.makedirs(root, exist_ok=True)
        make_synthetic_dataset(
            root, num_scans=1, viewpoints_per_scan=n_volumes,
            num_cams=cfg.num_cams, feat_hw=cfg.feat_h,
            feat_dim=cfg.in_channels,
            occ_dims=(cfg.occ_zdim, cfg.occ_ydim, cfg.occ_xdim),
            pc_range=cfg.pc_range, split="forall",
            image_hw=((cfg.feat_h * 16,) * 2 if images else None))
    return ann


def dump_rates(bev_only, cfg, ann: str, root: str, batch: int, passes: int,
               device, upload="auto", images: bool = False):
    """(rates, sca_overflow) of ``passes`` timed dumps after one untimed
    pass (allocator, page cache, the writer and transfer threads)."""
    from .data.mp3d import MP3DDataset
    from .ver_writer import dump_volumes

    ds = MP3DDataset(ann, root, num_cams=cfg.num_cams, feat_hw=cfg.feat_h,
                     voxel_num=cfg.voxel_num,
                     occupancy_classes=cfg.occupancy_classes, test_mode=True,
                     from_images=images)
    out = os.path.join(root, "images_ver.hdf5" if images else "ver.hdf5")
    kw = dict(batch_size=batch, device=device,
              input_cast=None if images else upload,
              input_key="images" if images else "features")
    rates, overflow = [], 0
    try:
        for i in range(passes + 1):
            if os.path.exists(out):
                os.remove(out)
            res = dump_volumes(bev_only, ds, cfg, out, **kw)
            overflow = max(overflow, res["sca_overflow"])
            if i:
                rates.append(res["volumes_per_sec"])
    finally:
        ds.close()
        if os.path.exists(out):
            os.remove(out)
    return rates, overflow


def measure(args, base=None) -> dict:
    """The bench line for parsed ``args``.  ``base`` is the configuration
    before the capacity is set (default: 36 cameras in bf16)."""
    import dataclasses

    from .get_occ import make_bev_only
    from .models import VERConfig, build_model
    from .runtime import resolve_device, set_fp32_precision
    from .utils.bench import card_name

    device = resolve_device(args.device)
    base = base or VERConfig(num_cams=NUM_CAMS, dtype=torch.bfloat16)
    e2e = not args.no_e2e
    if e2e:
        try:
            import h5py  # noqa: F401
        except ImportError:
            raise SystemExit(
                "the e2e legs read and write HDF5 and h5py is not "
                "installed: install it, or pass --no-e2e for the forward "
                "rates alone") from None
    set_fp32_precision(base.dtype)
    _, w2p, shift = example_inputs(base, batch=args.batch)
    qcap = (derived_qcap(base, w2p, shift) if args.qcap is None
            else args.qcap)
    cfg = dataclasses.replace(base, sca_query_capacity=qcap)
    model = build_model(cfg, device, seed=0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    vps, stats, overflow = forward_rate(model, cfg, args.batch, device,
                                        args.iters, args.repeats)
    line = {"metric": METRIC, "value": round(vps, 4), "unit": "volumes/s",
            "batch": args.batch, "qcap": qcap,
            "spread": round(stats["spread"], 4)}
    if args.alt_batch and args.alt_batch != args.batch:
        alt, _, alt_overflow = forward_rate(model, cfg, args.alt_batch,
                                            device, args.iters, args.repeats)
        line[f"value_batch{args.alt_batch}"] = round(alt, 4)
        overflow = max(overflow, alt_overflow)
    if overflow:
        line["sca_overflow"] = overflow

    if e2e:
        passes = max(1, args.e2e_passes)
        root = os.path.join(
            args.data_dir,
            f"torch_e2e_c{cfg.num_cams}_f{cfg.feat_h}x{cfg.in_channels}"
            f"_o{cfg.occ_zdim}x{cfg.occ_ydim}x{cfg.occ_xdim}"
            f"_n{args.e2e_volumes}{'' if args.no_images else '_img'}")
        ann = e2e_dataset(cfg, args.e2e_volumes, root, not args.no_images)
        rates, e2e_overflow = dump_rates(
            make_bev_only(model), cfg, ann, root, args.batch, passes, device,
            upload=args.upload)
        line.update(e2e_volumes_per_sec=round(float(np.median(rates)), 4),
                    e2e_rates=[round(r, 4) for r in rates],
                    e2e_spread=round((max(rates) - min(rates)) / max(rates),
                                     4),
                    e2e_upload=args.upload)
        if e2e_overflow:
            line["e2e_sca_overflow"] = int(e2e_overflow)
        if not args.no_images:
            from .models.vit import vit_for_ver
            vit = vit_for_ver(cfg, dtype=torch.bfloat16)
            vit.init_weights(torch.Generator().manual_seed(1))
            vit = vit.to(device).eval()
            rates, img_overflow = dump_rates(
                make_bev_only(model, vit), cfg, ann, root, args.batch, passes,
                device, images=True)
            line.update(e2e_from_images=round(float(np.median(rates)), 4),
                        e2e_from_images_rates=[round(r, 4) for r in rates])
            if img_overflow:
                line["e2e_from_images_sca_overflow"] = int(img_overflow)
    line.update(card=card_name(device), peak_mib=(
        round(torch.cuda.max_memory_allocated(device) / 2 ** 20, 1)
        if device.type == "cuda" else None))
    return line


def main(argv=None, base=None) -> dict:
    line = measure(parse_args(argv), base)
    print(json.dumps(line), flush=True)
    worst = max(line.get(k, 0) for k in (
        "sca_overflow", "e2e_sca_overflow", "e2e_from_images_sca_overflow"))
    if worst:
        sys.exit(f"sca_query_capacity overflow: {worst} visible queries "
                 "beyond capacity in the worst camera slot; the rates are "
                 "of a truncated lift. Raise --qcap (python -m "
                 "vln_ver_tpu_torch.check_query_capacity sizes it).")
    return line


if __name__ == "__main__":
    main()
