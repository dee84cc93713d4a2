"""3D box codec: the 10-code (cx, cy, w, l, cz, h, sin, cos, vx, vy)
format (PyTorch port of ``vln_ver_tpu/boxes.py``; reference
core/bbox/util.py:4-53).

* "raw" boxes (annotations): ``(cx, cy, z_bottom, w, l, h, yaw)``;
* "gravity" boxes: ``(cx, cy, cz, w, l, h, yaw, vx, vy)`` with cz at the
  box centre (voxelformer_occupancy_head.py:1311-1317);
* "normalized" boxes: the 10-code above with log sizes.
"""

from __future__ import annotations

import numpy as np
import torch


def gravity_boxes_from_raw(raw: np.ndarray) -> np.ndarray:
    """(N, 7|9) raw (cx, cy, z_bottom, w, l, h, yaw[, vx, vy]) -> (N, 9)
    gravity boxes on the host: cz = z_bottom + h / 2, velocity columns
    passed through where present, zero otherwise."""
    out = np.zeros((raw.shape[0], 9), np.float32)
    out[:, :min(raw.shape[1], 9)] = raw[:, :9]
    out[:, 2] = raw[:, 2] + raw[:, 5] * 0.5
    return out


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """(..., 7|9) gravity boxes -> (..., 8|10) normalized regression codes
    (cx, cy, log w, log l, cz, log h, sin yaw, cos yaw[, vx, vy])."""
    parts = [bboxes[..., 0:1], bboxes[..., 1:2], bboxes[..., 3:4].log(),
             bboxes[..., 4:5].log(), bboxes[..., 2:3], bboxes[..., 5:6].log(),
             bboxes[..., 6:7].sin(), bboxes[..., 6:7].cos()]
    if bboxes.shape[-1] > 7:
        parts += [bboxes[..., 7:8], bboxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def denormalize_bbox(normalized: torch.Tensor) -> torch.Tensor:
    """(..., 8|10) normalized codes -> (..., 7|9) gravity boxes:
    yaw = atan2(sin, cos), sizes exponentiated."""
    rot = torch.atan2(normalized[..., 6:7], normalized[..., 7:8])
    parts = [normalized[..., 0:1], normalized[..., 1:2],
             normalized[..., 4:5], normalized[..., 2:3].exp(),
             normalized[..., 3:4].exp(), normalized[..., 5:6].exp(), rot]
    if normalized.shape[-1] > 8:
        parts += [normalized[..., 8:9], normalized[..., 9:10]]
    return torch.cat(parts, dim=-1)
