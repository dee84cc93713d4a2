"""Synthetic MP3D-format scenes (the port's copy of
``vln_ver_tpu/data/synthetic.py``).

A rectangular room with floor, ceiling and walls plus a few boxes; the
occupancy is rasterised analytically and the ViT features are random.
Every artifact draws from its own keyed random stream, with the JAX
package's keys, headings (70 degree pinhole cameras at
``deg * 360 / num_cams``) and on-disk format, so a ``--synthetic`` run of
either package writes the same dataset.

* :func:`make_synthetic_dataset` writes it under a root (needs ``h5py``);
* :func:`synthetic_samples` returns the same viewpoints in memory, as the
  sample dicts :class:`~vln_ver_tpu_torch.data.mp3d.MP3DDataset` reads
  from that root (no ``h5py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import zlib
from typing import Dict, List

import numpy as np

from ..geometry import make_pinhole_world2pixel
from .mp3d import ground_truth, occupancy_ground_truth

# occupancy class ids from vocc.py occupancy_name
FLOOR, WALL, CEILING = 2, 1, 14
EMPTY = 16
PC_RANGE = (-6.0, -6.0, -1.5, 6.0, 6.0, 2.0)
OCC_DIMS = (35, 120, 120)


def _key_rng(seed: int, split: str, *idx: int) -> np.random.Generator:
    """Generator keyed on (seed, split, indices): every artifact draws from
    its own stream, so regenerating over a partly populated root rewrites
    identical bytes."""
    return np.random.default_rng(
        [seed, zlib.crc32(split.encode("utf-8")), *idx])


def _rasterise_scene(rng: np.random.Generator, pc_range=PC_RANGE,
                     occ_dims=OCC_DIMS, num_boxes: int = 4):
    """Room, boxes and occupancy of one viewpoint: (sparse (M, 2),
    invalid flat indices, raw boxes (N, 7), labels (N,), layout (7,))."""
    zd, yd, xd = occ_dims
    lo = np.asarray(pc_range[:3])
    hi = np.asarray(pc_range[3:])
    dense = np.full(zd * yd * xd, EMPTY, dtype=np.int32)
    zz, yy, xx = np.meshgrid(np.arange(zd), np.arange(yd), np.arange(xd),
                             indexing="ij")
    cx = (xx + 0.5) / xd * (hi[0] - lo[0]) + lo[0]
    cy = (yy + 0.5) / yd * (hi[1] - lo[1]) + lo[1]
    cz = (zz + 0.5) / zd * (hi[2] - lo[2]) + lo[2]

    def flat(m):
        return m.reshape(-1)

    room_half = rng.uniform(3.0, 5.5)
    # floor and ceiling bands at least one voxel thick, so that coarse
    # grids still rasterise structure
    z_vox = (hi[2] - lo[2]) / zd
    floor_z = lo[2] + max(0.15, 1.01 * z_vox)
    ceil_z = hi[2] - max(0.15, 1.01 * z_vox)
    xy_vox = max((hi[0] - lo[0]) / xd, (hi[1] - lo[1]) / yd)
    wall_band = max(0.2, 1.01 * xy_vox)
    inside = (np.abs(cx) < room_half) & (np.abs(cy) < room_half)
    dense[flat(inside & (cz < floor_z))] = FLOOR
    dense[flat(inside & (cz > ceil_z))] = CEILING
    wall = inside & (np.maximum(np.abs(cx), np.abs(cy))
                     > room_half - wall_band)
    dense[flat(wall & (cz >= floor_z) & (cz <= ceil_z))] = WALL

    boxes, labels = [], []
    for _ in range(num_boxes):
        w, l, h = rng.uniform(0.4, 1.5, 3)
        bx = rng.uniform(-room_half + 1, room_half - 1)
        by = rng.uniform(-room_half + 1, room_half - 1)
        bz = floor_z  # bottom on the floor
        yaw = rng.uniform(-np.pi, np.pi)
        boxes.append([bx, by, bz, w, l, h, yaw])
        labels.append(int(rng.integers(0, 17)))
        occ_cls = int(rng.integers(3, 16))
        in_box = ((np.abs(cx - bx) < w / 2) & (np.abs(cy - by) < l / 2)
                  & (cz >= bz) & (cz <= bz + h))
        dense[flat(in_box)] = occ_cls

    idx = np.nonzero(dense != EMPTY)[0]
    sparse = np.stack([idx, dense[idx]], axis=-1).astype(np.int64)
    layout = [0.0, 0.0, floor_z, 2 * room_half, 2 * room_half,
              ceil_z - floor_z, 0.0]
    # everything beyond the room walls is unobserved (reference occ_invalid
    # npy, mp3docc_dataset.py:512-517)
    invalid = np.nonzero(flat(~inside))[0].astype(np.int64)
    return sparse, invalid, np.asarray(boxes, np.float32), np.asarray(
        labels, np.int64), np.asarray(layout, np.float32)


def _scan_name(split: str, s: int) -> str:
    # splits share a root, so scans are namespaced by split
    return f"scan{s:03d}" if split == "trainval" else f"{split}scan{s:03d}"


def _viewpoint(seed: int, split: str, s: int, v: int, occ_dims, pc_range):
    """(position (3,) float64, annotation dict, sparse occupancy, invalid
    voxels) of viewpoint ``v`` of scan ``s``: the position is the first
    draw of the viewpoint's stream, the scene the rest.  The cameras are
    built from the float64 position, the origin shift is its float32."""
    token = f"{_scan_name(split, s)}_vp{v:03d}"
    vrng = _key_rng(seed, split, s, v)
    pos = vrng.uniform(-1.0, 1.0, 3) * np.array([1, 1, 0.3])
    sparse, invalid, boxes, labels, layout = _rasterise_scene(
        vrng, pc_range=pc_range, occ_dims=occ_dims)
    info = {"token": token, "scene_name": _scan_name(split, s),
            "gt_boxes": boxes, "names": ["chair"] * len(labels),
            "labels": labels, "layout": layout}
    return pos, info, sparse, invalid


def _feature(seed: int, split: str, s: int, v: int, deg: int, feat_hw: int,
             feat_dim: int) -> np.ndarray:
    """(1, feat_hw**2 + 1, feat_dim): the HDF5 row, CLS token first."""
    return _key_rng(seed, split, s, v, deg, 0).standard_normal(
        (1, feat_hw * feat_hw + 1, feat_dim)).astype(np.float32)


def _image(seed: int, split: str, s: int, v: int, deg: int,
           image_hw) -> np.ndarray:
    """(H, W, 3) uint8: one random panorama view, independent of the
    features."""
    return _key_rng(seed, split, s, v, deg, 1).integers(
        0, 256, (*image_hw, 3)).astype(np.uint8)


def _world2pixel(num_cams: int, deg: int, pos) -> np.ndarray:
    return make_pinhole_world2pixel(70.0, deg * (360.0 / num_cams), pos)


def synthetic_samples(num_scans: int = 2, viewpoints_per_scan: int = 2,
                      num_cams: int = 6, feat_hw: int = 14,
                      feat_dim: int = 768, occ_dims=OCC_DIMS,
                      pc_range=PC_RANGE, seed: int = 0,
                      split: str = "test") -> List[Dict]:
    """The viewpoints :func:`make_synthetic_dataset` writes, as the sample
    dicts ``MP3DDataset(..., test_mode=False)`` reads back, in memory."""
    voxel_num = int(np.prod(occ_dims))
    samples = []
    for s in range(num_scans):
        for v in range(viewpoints_per_scan):
            pos, info, sparse, invalid = _viewpoint(seed, split, s, v,
                                                    occ_dims, pc_range)
            sample = {
                "features": np.stack([
                    _feature(seed, split, s, v, deg, feat_hw, feat_dim)
                    [0, 1:].reshape(feat_hw, feat_hw, feat_dim)
                    for deg in range(num_cams)]),
                "world2pixel": np.stack([
                    _world2pixel(num_cams, deg, pos).astype(np.float32)
                    for deg in range(num_cams)]),
                "origin_shift": pos.astype(np.float32),
                "token": info["token"],
            }
            sample.update(ground_truth(info))
            sample.update(occupancy_ground_truth(sparse, invalid, voxel_num,
                                                 EMPTY))
            samples.append(sample)
    return samples


def make_synthetic_dataset(root: str,
                           num_scans: int = 2,
                           viewpoints_per_scan: int = 2,
                           num_cams: int = 6,
                           feat_hw: int = 14,
                           feat_dim: int = 768,
                           occ_dims=OCC_DIMS,
                           pc_range=PC_RANGE,
                           seed: int = 0,
                           split: str = "trainval",
                           image_hw=None) -> str:
    """Write features, cameras, origin shifts, the annotation pkl and the
    occupancy npys under ``root``; returns the annotation path.

    With ``image_hw`` (H, W) it also writes random uint8 views to
    ``panorama_images.hdf5`` under the features' keys (the fused image
    path's input).  Every artifact has its own keyed stream, so a second
    call over a populated root rewrites the same bytes and adds only the
    missing HDF5 keys."""
    import h5py

    os.makedirs(os.path.join(root, "world2pixel"), exist_ok=True)
    os.makedirs(os.path.join(root, "occ"), exist_ok=True)
    infos = []
    cords = {}
    feat_path = os.path.join(root, "new_vit_base_patch16_197_imagenet.hdf5")
    img_path = os.path.join(root, "panorama_images.hdf5")
    mode = "a" if os.path.exists(feat_path) else "w"
    with h5py.File(feat_path, mode) as h5, contextlib.ExitStack() as files:
        img_h5 = None if image_hw is None else files.enter_context(
            h5py.File(img_path, "a" if os.path.exists(img_path) else "w"))
        for s in range(num_scans):
            scan = _scan_name(split, s)
            cam_json = {}
            for v in range(viewpoints_per_scan):
                pos, info, sparse, invalid = _viewpoint(seed, split, s, v,
                                                        occ_dims, pc_range)
                token = info["token"]
                cords[token] = pos.astype(np.float32)
                for deg in range(num_cams):
                    cam_json[f"vp{v:03d}_i1_{deg}"] = _world2pixel(
                        num_cams, deg, pos).tolist()
                    fkey = f"{token}_i1_{deg}"
                    if fkey not in h5:
                        h5.create_dataset(fkey, data=_feature(
                            seed, split, s, v, deg, feat_hw, feat_dim))
                    if img_h5 is not None and fkey not in img_h5:
                        img_h5.create_dataset(fkey, data=_image(
                            seed, split, s, v, deg, image_hw))
                info["occ_gt_path"] = os.path.join(root, "occ",
                                                   f"{token}.npy")
                np.save(info["occ_gt_path"], sparse)
                info["occ_invalid_path"] = os.path.join(
                    root, "occ", f"{token}_invalid.npy")
                np.save(info["occ_invalid_path"], invalid)
                infos.append(info)
            # merge with an existing per-scan camera file: splits share the
            # root, and a later split must not clobber an earlier one's
            cam_path = os.path.join(root, "world2pixel", scan + ".json")
            if os.path.exists(cam_path):
                with open(cam_path) as f:
                    merged = json.load(f)
                merged.update(cam_json)
                cam_json = merged
            with open(cam_path, "w") as f:
                json.dump(cam_json, f)

    cord_path = os.path.join(root, "scanvp2cord.pkl")
    if os.path.exists(cord_path):
        with open(cord_path, "rb") as f:
            prev = pickle.load(f)
        prev.update(cords)
        cords = prev
    with open(cord_path, "wb") as f:
        pickle.dump(cords, f)
    ann_path = os.path.join(root, f"mp3d_{split}.pkl")
    with open(ann_path, "wb") as f:
        pickle.dump(infos, f)
    return ann_path
