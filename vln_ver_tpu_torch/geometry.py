"""Voxel-grid reference points and multi-camera projection (PyTorch port).

fp32 functions of tensors.  The camera matrices and the origin shift are
plain tensor arguments supplied per sample by the input pipeline (the
reference re-read them from disk inside every forward).
"""

from __future__ import annotations

import numpy as np
import torch

# MP3D panorama image plane used to normalise pixel coordinates
# (reference voxel_encoder.py:179-180).
IMAGE_WH = (1280.0, 1024.0)

# Default VER scene range [x_min, y_min, z_min, x_max, y_max, z_max] in metres
# (reference projects/configs/verformer/vocc.py:9).
PC_RANGE = (-6.0, -6.0, -1.5, 6.0, 6.0, 2.0)


def voxel_reference_points(bev_z: int, bev_h: int, bev_w: int,
                           device=None) -> torch.Tensor:
    """Normalised 3D centres of the coarse voxel-query grid.

    Returns ``(bev_z*bev_h*bev_w, 3)`` fp32 with columns (x, y, z) in
    [0, 1], voxel centres at ``(i + 0.5) / dim``; flat order is z-major,
    then h (y), then w (x).
    """
    def centres(n):
        return (torch.arange(n, dtype=torch.float32, device=device)
                + 0.5) / n
    z, y, x = torch.meshgrid(centres(bev_z), centres(bev_h),
                             centres(bev_w), indexing="ij")
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def pillar_reference_points(bev_h: int, bev_w: int,
                            num_points_in_pillar: int = 4,
                            z_extent: float | None = None,
                            device=None) -> torch.Tensor:
    """Normalised pillar sampling points of a 2D BEV grid.

    Each BEV cell is sampled at ``num_points_in_pillar`` heights,
    ``linspace(0.5, Z - 0.5, P) / Z`` with ``Z`` the metric pillar height
    ``z_extent`` (the pc-range z extent: a 0.5 m margin at both ends);
    omitted, ``Z == P``.  Returns ``(bev_h*bev_w, P, 3)`` fp32 (x, y, z)
    in [0, 1]; flat order is h-major then w, anchors bottom-up.
    """
    p = num_points_in_pillar
    z_top = float(z_extent) if z_extent is not None else float(p)
    zs = torch.linspace(0.5, z_top - 0.5, p, dtype=torch.float32,
                        device=device) / z_top
    xy = bev_reference_points(bev_h, bev_w, device=device)   # (hw, 2)
    return torch.cat([xy[:, None, :].expand(-1, p, 2),
                      zs[None, :, None].expand(xy.shape[0], p, 1)], dim=-1)


def bev_reference_points(bev_h: int, bev_w: int,
                         device=None) -> torch.Tensor:
    """Normalised 2D BEV cell centres, ``(bev_h*bev_w, 2)`` fp32 (x, y) in
    [0, 1], h-major flat order: the reference points of the 2D temporal
    self-attention."""
    def centres(n):
        return (torch.arange(n, dtype=torch.float32, device=device)
                + 0.5) / n
    y, x = torch.meshgrid(centres(bev_h), centres(bev_w), indexing="ij")
    return torch.stack([x, y], dim=-1).reshape(-1, 2)


def project_reference_points(ref_xyz: torch.Tensor,
                             world2pixel: torch.Tensor,
                             origin_shift: torch.Tensor,
                             pc_range=PC_RANGE,
                             image_wh=IMAGE_WH,
                             eps: float = 1e-5):
    """Project normalised voxel centres into every camera.

    Args:
      ref_xyz: ``(num_query, 3)`` normalised (x, y, z) in [0, 1].
      world2pixel: ``(..., num_cam, 4, 4)`` world->pixel matrices.
      origin_shift: ``(..., 3)`` world-frame translation of the viewpoint;
        its leading dims match those of ``world2pixel``.
      pc_range: scene bounds used to denormalise ``ref_xyz``.
      image_wh: image plane size for pixel-coordinate normalisation.
      eps: depth clamp (the reference uses 1e-5).

    Returns:
      ``(cam_xy, mask)``: ``cam_xy`` ``(..., num_cam, num_query, 2)``
      normalised image coordinates, NaN/inf removed and clipped to
      [-1, 2]; ``mask`` ``(..., num_cam, num_query)`` bool, True where the
      point lies in front of the camera and strictly inside the image.
    """
    dev = world2pixel.device
    ref_xyz = ref_xyz.to(dev, torch.float32)
    world2pixel = world2pixel.to(torch.float32)
    origin_shift = origin_shift.to(dev, torch.float32)
    pc = torch.tensor(pc_range, dtype=torch.float32, device=dev)

    world = (ref_xyz * (pc[3:6] - pc[0:3]) + pc[0:3]
             + origin_shift[..., None, :])                 # (..., nq, 3)
    homo = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    # (..., cam, nq, 4) = (..., cam, 4, 4) @ (..., nq, 4)
    cam = torch.einsum("...cij,...qj->...cqi", world2pixel, homo)

    depth = cam[..., 2:3]
    in_front = depth[..., 0] > eps
    xy = cam[..., 0:2] / torch.clamp(depth, min=eps)
    xy = xy / torch.tensor(image_wh, dtype=torch.float32, device=dev)

    mask = (in_front
            & (xy[..., 0] > 0.0) & (xy[..., 0] < 1.0)
            & (xy[..., 1] > 0.0) & (xy[..., 1] < 1.0))
    # masked-out coordinates stay finite and tame so the dense (masked)
    # bilinear sampling never sees inf/NaN
    xy = torch.clamp(torch.nan_to_num(xy), -1.0, 2.0)
    return xy, mask


def max_visible_queries(world2pixel: np.ndarray,
                        origin_shift: np.ndarray,
                        bev_z: int = 4, bev_h: int = 15, bev_w: int = 15,
                        pc_range=PC_RANGE,
                        image_wh=IMAGE_WH) -> int:
    """Largest per-camera visible voxel-query count over a batch: the
    least safe ``VERConfig.sca_query_capacity``.

    Pure numpy, on the host (dataset validation before the capacity-bounded
    sparse lift is turned on).  ``world2pixel`` is (..., cam, 4, 4) and
    ``origin_shift`` (..., 3) with matching leading dims.  It repeats
    :func:`project_reference_points`'s visibility test in float64 on the
    float32 world points, with the bounds dilated by 1e-4, so a projection
    within rounding of an image edge, which the device may count visible,
    is counted here too: the bound never under-counts."""
    w2p = np.asarray(world2pixel, np.float32)
    shift = np.asarray(origin_shift, np.float32)

    def centres(n):
        return (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
            / np.float32(n)
    z, y, x = np.meshgrid(centres(bev_z), centres(bev_h), centres(bev_w),
                          indexing="ij")
    ref = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    pc = np.asarray(pc_range, np.float32)
    world = ref * (pc[3:6] - pc[0:3]) + pc[0:3]        # (nq, 3)
    world = world[None] + shift.reshape(-1, 1, 3)      # (B, nq, 3)
    homo = np.concatenate([world, np.ones_like(world[..., :1])], -1)
    cam = np.einsum("xcij,xqj->xcqi",
                    w2p.reshape(-1, *w2p.shape[-3:]).astype(np.float64),
                    homo.astype(np.float64))
    depth = cam[..., 2]
    eps = 1e-5
    tol = 1e-4   # the fp32-rounding dilation of the visibility boundary
    xy = cam[..., 0:2] / np.maximum(depth, eps)[..., None]
    xy = xy / np.asarray(image_wh, np.float64)
    vis = ((depth > eps * (1.0 - tol))
           & (xy[..., 0] > -tol) & (xy[..., 0] < 1.0 + tol)
           & (xy[..., 1] > -tol) & (xy[..., 1] < 1.0 + tol))
    return int(vis.sum(-1).max())


def make_pinhole_world2pixel(fov_deg: float,
                             yaw_deg: float,
                             position,
                             image_wh=IMAGE_WH) -> np.ndarray:
    """Build a 4x4 world->pixel matrix for a y-forward pinhole camera.

    Utility for synthetic data and tests (the real matrices come from the
    MP3D ``world2pixel`` JSON files).  The camera sits at ``position`` with
    heading ``yaw_deg`` about +z (0 deg looks along +y), horizontal and
    vertical FoV ``fov_deg``.
    """
    w, h = image_wh
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    fy = 0.5 * h / np.tan(np.radians(fov_deg) / 2)
    intr = np.array([[f, 0, w / 2], [0, fy, h / 2], [0, 0, 1.0]])
    cy, sy = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    # world axes -> camera axes: camera x = right, y = down, z = forward
    rot_world = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    forward = rot_world @ np.array([0.0, 1.0, 0.0])
    right = rot_world @ np.array([1.0, 0.0, 0.0])
    down = np.array([0.0, 0.0, -1.0])
    r_cam = np.stack([right, down, forward], axis=0)  # world->cam rotation
    t = -r_cam @ np.asarray(position, dtype=np.float64)
    ext = np.eye(4)
    ext[:3, :3] = r_cam
    ext[:3, 3] = t
    proj = np.eye(4)
    proj[:3, :3] = intr
    return (proj @ ext).astype(np.float32)
