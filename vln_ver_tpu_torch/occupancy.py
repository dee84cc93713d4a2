"""Occupancy ground truth and prediction decoding (PyTorch port of
``vln_ver_tpu/occupancy.py``).

The occupancy grid is ``occ_zdim x occ_ydim x occ_xdim`` (35 x 120 x 120
at 0.1 m) flattened z-major, then y, then x.  Ground truth is stored
sparsely as ``(M, 2)`` ``(flat_index, class)`` pairs; class
``occupancy_classes`` (16) is empty space (reference
mp3docc_dataset.py:505-509, 579-584).
"""

from __future__ import annotations

import numpy as np
import torch

OCC_CLASSES = 16


def dense_from_sparse_np(sparse: np.ndarray, voxel_num: int,
                         empty_class: int = OCC_CLASSES) -> np.ndarray:
    """(M, 2) (index, class) pairs -> (voxel_num,) int32 dense classes;
    indices outside [0, voxel_num) are dropped, never wrapped."""
    dense = np.full(voxel_num, empty_class, dtype=np.int32)
    if len(sparse):
        idx = sparse[:, 0].astype(np.int64)
        k = (idx >= 0) & (idx < voxel_num)
        dense[idx[k]] = sparse[:, 1][k]
    return dense


def decode_occupancy_focal(logits: torch.Tensor,
                           threshold: float = 0.25) -> torch.Tensor:
    """Sigmoid (focal-loss) decode: a voxel takes its best class where
    that class's score exceeds ``threshold``, else empty (= the channel
    count), as the reference's appended threshold column does
    (head:1513-1520).  (..., n) -> (...) int32."""
    best, cls = logits.sigmoid().max(dim=-1)
    empty = torch.full_like(cls, logits.shape[-1])
    return torch.where(best > threshold, cls, empty).to(torch.int32)


def decode_occupancy_ce(logits: torch.Tensor) -> torch.Tensor:
    """Softmax (ce-loss) decode: argmax; the last channel is empty
    (head:1527-1533)."""
    return logits.argmax(dim=-1).to(torch.int32)


def decode_occupancy(logits: torch.Tensor, threshold: float = 0.25,
                     loss_type: str = "focal_loss") -> torch.Tensor:
    """Loss-type dispatch of the reference's ``get_occupancy_prediction``
    (head:1504-1536)."""
    if loss_type == "ce_loss":
        return decode_occupancy_ce(logits)
    if loss_type == "focal_loss":
        return decode_occupancy_focal(logits, threshold)
    raise NotImplementedError(f"occ_loss_type {loss_type!r}")


def occupancy_num_classes(occupancy_classes: int,
                          loss_type: str = "focal_loss") -> int:
    """Class count INCLUDING empty, for the metric histograms: focal mode
    appends empty as id ``occupancy_classes``; ce mode's channels already
    end with it."""
    return (occupancy_classes if loss_type == "ce_loss"
            else occupancy_classes + 1)
