"""The one traffic generator: a pool of synthetic MP3D viewpoints.

A frozen copy of the port's ``data/synthetic.py`` draws (and of
``geometry.make_pinhole_world2pixel``), so that a change to the program
cannot move the yardstick:

* features: standard normal, ``(cams, feat_h, feat_w, C)`` a viewpoint,
  drawn here on the device by a seeded ``torch.Generator`` in one call;
* cameras: ``num_cams`` y-forward pinholes of ``fov_deg`` at yaw
  ``k * 360 / num_cams``, all at the viewpoint's position, which is drawn
  uniform in [-1, 1] times ``position_scale``; the origin shift is that
  position in fp32;
* ground truth (training): a rectangular room of half-width U(3, 5.5) m
  with floor, ceiling and walls rasterised on the occupancy grid, and
  ``num_boxes`` boxes of U(0.4, 1.5) m sides standing on the floor, each
  with a class label and an occupancy class.

A traffic file (``verbench/traffic/<name>.json``) holds the parameters:
``pool`` viewpoints, ``batch``, and those above.  Every seed gives the
same sizes; only the values and the order differ.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np
import torch

from .reference.arch import Arch, _stream

FLOOR, WALL, CEILING = 2, 1, 14
MAX_GT = 32


def pinhole_world2pixel(fov_deg: float, yaw_deg: float, position,
                        image_wh) -> np.ndarray:
    """4x4 world -> pixel matrix of a y-forward pinhole at ``position``
    with heading ``yaw_deg`` about +z (0 looks along +y)."""
    w, h = image_wh
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    fy = 0.5 * h / np.tan(np.radians(fov_deg) / 2)
    intr = np.array([[f, 0, w / 2], [0, fy, h / 2], [0, 0, 1.0]])
    cy, sy = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    rot = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    forward = rot @ np.array([0.0, 1.0, 0.0])
    right = rot @ np.array([1.0, 0.0, 0.0])
    down = np.array([0.0, 0.0, -1.0])
    r_cam = np.stack([right, down, forward], axis=0)
    ext = np.eye(4)
    ext[:3, :3] = r_cam
    ext[:3, 3] = -r_cam @ np.asarray(position, dtype=np.float64)
    proj = np.eye(4)
    proj[:3, :3] = intr
    return (proj @ ext).astype(np.float32)


def _rng(seed: int, *idx: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), zlib.crc32(b"verbench"), *idx])


def cameras(a: Arch, t: Dict, seed: int):
    """(world2pixel (pool, cams, 4, 4) fp32, origin_shift (pool, 3) fp32)
    on the host."""
    n = int(t["pool"])
    scale = np.asarray(t.get("position_scale", (1.0, 1.0, 0.3)))
    w2p = np.empty((n, a.num_cams, 4, 4), np.float32)
    shift = np.empty((n, 3), np.float32)
    for v in range(n):
        pos = _rng(seed, v, 0).uniform(-1.0, 1.0, 3) * scale
        shift[v] = pos.astype(np.float32)
        for k in range(a.num_cams):
            w2p[v, k] = pinhole_world2pixel(
                float(t.get("fov_deg", 70.0)), k * 360.0 / a.num_cams, pos,
                a.image_wh)
    return w2p, shift


def features(a: Arch, t: Dict, seed: int, device,
             dtype=torch.float32, cls_token: bool = False) -> torch.Tensor:
    """(pool, cams, feat_h, feat_w, C) standard-normal features on
    ``device``, drawn in one call; with ``cls_token`` the HDF5 rows
    (pool, cams, 1 + feat_h * feat_w, C), the CLS token first."""
    n = int(t["pool"])
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream(seed, 2))
    hw = a.feat_h * a.feat_w + (1 if cls_token else 0)
    x = torch.empty((n, a.num_cams, hw, a.in_channels), dtype=torch.float32,
                    device=device)
    x.normal_(generator=gen)
    if not cls_token:
        x = x.view(n, a.num_cams, a.feat_h, a.feat_w, a.in_channels)
    return x.to(dtype)


def order(seed: int, pool: int, batch: int, cycles: int) -> np.ndarray:
    """(cycles * pool // batch, batch) viewpoint indices: each cycle a new
    permutation of the pool cut into batches, so no two batches of a
    run are the same."""
    rng = _rng(seed, 1 << 20)
    rows = [rng.permutation(pool) for _ in range(cycles)]
    return np.concatenate(rows).reshape(-1, batch)


def ground_truth(a: Arch, t: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """Per viewpoint: ``gt_boxes`` (MAX_GT, 9) gravity boxes (cx, cy, cz,
    w, l, h, yaw, vx, vy), ``gt_labels`` (MAX_GT,), ``gt_valid``
    (MAX_GT,) and ``occ_dense`` (voxel_num,) labels, empty =
    ``occupancy_classes``, flat order z, y, x."""
    zd, yd, xd = a.occ_zdim, a.occ_ydim, a.occ_xdim
    lo = np.asarray(a.pc_range[:3])
    hi = np.asarray(a.pc_range[3:])
    zz, yy, xx = np.meshgrid(np.arange(zd), np.arange(yd), np.arange(xd),
                             indexing="ij")
    cx = ((xx + 0.5) / xd * (hi[0] - lo[0]) + lo[0]).reshape(-1)
    cy = ((yy + 0.5) / yd * (hi[1] - lo[1]) + lo[1]).reshape(-1)
    cz = ((zz + 0.5) / zd * (hi[2] - lo[2]) + lo[2]).reshape(-1)
    empty = a.occupancy_classes
    out = []
    for v in range(int(t["pool"])):
        rng = _rng(seed, v, 1)
        dense = np.full(zd * yd * xd, empty, dtype=np.int32)
        half = rng.uniform(3.0, 5.5)
        z_vox = (hi[2] - lo[2]) / zd
        floor_z = lo[2] + max(0.15, 1.01 * z_vox)
        ceil_z = hi[2] - max(0.15, 1.01 * z_vox)
        band = max(0.2, 1.01 * max((hi[0] - lo[0]) / xd, (hi[1] - lo[1]) / yd))
        inside = (np.abs(cx) < half) & (np.abs(cy) < half)
        dense[inside & (cz < floor_z)] = FLOOR
        dense[inside & (cz > ceil_z)] = CEILING
        wall = inside & (np.maximum(np.abs(cx), np.abs(cy)) > half - band)
        dense[wall & (cz >= floor_z) & (cz <= ceil_z)] = WALL
        boxes = np.zeros((MAX_GT, 9), np.float32)
        labels = np.zeros((MAX_GT,), np.int64)
        valid = np.zeros((MAX_GT,), bool)
        for i in range(int(t.get("num_boxes", 4))):
            w, l, h = rng.uniform(0.4, 1.5, 3)
            bx = rng.uniform(-half + 1, half - 1)
            by = rng.uniform(-half + 1, half - 1)
            yaw = rng.uniform(-np.pi, np.pi)
            boxes[i, :7] = [bx, by, floor_z + h / 2, w, l, h, yaw]
            labels[i] = rng.integers(0, a.num_classes)
            valid[i] = True
            in_box = ((np.abs(cx - bx) < w / 2) & (np.abs(cy - by) < l / 2)
                      & (cz >= floor_z) & (cz <= floor_z + h))
            dense[in_box] = rng.integers(3, empty)
        out.append(dict(gt_boxes=boxes, gt_labels=labels, gt_valid=valid,
                        occ_dense=dense))
    return out
