"""Semantic scene completion metrics: per-class IoU, mIoU and completion
IoU / precision / recall (the port's copy of
``vln_ver_tpu/evaluation/ssc_metrics.py``).

An (n x n) confusion histogram over class ids, rows ground truth and
columns prediction, whose last class is empty (reference
occupancy_metrics.py:3-105); completion counts any non-empty class as
positive.  IoUs are in percent.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_hist_device(pred: torch.Tensor, gt: torch.Tensor,
                          weight: torch.Tensor,
                          n_classes: int) -> torch.Tensor:
    """``hist[gt, pred] += weight`` on the tensors' device: the
    accumulation of :meth:`SSCMetrics.add_batch` as one ``bincount`` over
    ``gt * n + pred``.  A voxel counts where its 0/1 ``weight`` is set and
    both ``gt`` and ``pred`` lie in [0, n); the others go to an overflow
    bin that is dropped.  Returns (n, n) int64."""
    gt = gt.long()
    pred = pred.long()
    keep = ((weight != 0) & (gt >= 0) & (gt < n_classes)
            & (pred >= 0) & (pred < n_classes))
    idx = torch.where(keep, gt * n_classes + pred,
                      torch.full_like(gt, n_classes * n_classes))
    hist = torch.bincount(idx.reshape(-1), minlength=n_classes ** 2 + 1)
    return hist[:n_classes ** 2].reshape(n_classes, n_classes)


class SSCMetrics:
    def __init__(self, n_classes: int = 17,
                 eval_far: bool = False, eval_near: bool = False,
                 near_distance: float = 10.0, far_distance: float = 30.0,
                 pc_range=(-6.0, -6.0, -1.5, 6.0, 6.0, 2.0),
                 occ_dims=(35, 120, 120)):
        """``n_classes`` INCLUDES the empty class (17 = 16 + empty).

        ``eval_far`` / ``eval_near`` restrict accumulation to voxels
        beyond / within a BEV distance of the origin (reference
        occupancy_metrics.py:92-105)."""
        self.n_classes = n_classes
        self.hist = np.zeros((n_classes, n_classes), dtype=np.float64)
        self.distance_mask = None
        if eval_far or eval_near:
            zd, yd, xd = occ_dims
            lo = np.asarray(pc_range[:3])
            hi = np.asarray(pc_range[3:])
            _, y, x = np.meshgrid(np.arange(zd), np.arange(yd),
                                  np.arange(xd), indexing="ij")
            px = (x.reshape(-1) + 0.5) / xd * (hi[0] - lo[0]) + lo[0]
            py = (y.reshape(-1) + 0.5) / yd * (hi[1] - lo[1]) + lo[1]
            dist = np.hypot(px, py)
            mask = np.ones(dist.shape, bool)
            if eval_far:
                mask &= dist > far_distance
            if eval_near:
                mask &= dist < near_distance
            self.distance_mask = mask

    def add_batch(self, y_pred: np.ndarray, y_true: np.ndarray,
                  visible_mask: np.ndarray | None = None) -> None:
        """Host accumulation.  A voxel counts where it is visible AND
        inside the far/near band, and where both labels lie in [0, n)."""
        y_pred = np.asarray(y_pred).reshape(-1).astype(np.int64)
        y_true = np.asarray(y_true).reshape(-1).astype(np.int64)
        keep = None
        if visible_mask is not None:
            keep = np.asarray(visible_mask).reshape(-1) == 1
        if self.distance_mask is not None:
            keep = (self.distance_mask if keep is None
                    else keep & self.distance_mask)
        if keep is not None:
            y_pred = y_pred[keep]
            y_true = y_true[keep]
        n = self.n_classes
        k = ((y_true >= 0) & (y_true < n) & (y_pred >= 0) & (y_pred < n))
        self.hist += np.bincount(n * y_true[k] + y_pred[k],
                                 minlength=n * n).reshape(n, n)

    def get_stats(self) -> dict:
        hist = self.hist
        iou_per_class = np.diag(hist) / (
            hist.sum(1) + hist.sum(0) - np.diag(hist) + 1e-6) * 100.0
        completion_tp = np.sum(hist[:-1, :-1])
        completion_fp = np.sum(hist[-1, :-1])
        completion_fn = np.sum(hist[:-1, -1])
        if completion_tp != 0:
            precision = completion_tp / (completion_tp + completion_fp)
            recall = completion_tp / (completion_tp + completion_fn)
            iou = completion_tp / (
                completion_tp + completion_fp + completion_fn) * 100.0
        else:
            precision, recall, iou = 0.0, 0.0, 0.0
        iou_ssc = iou_per_class[: self.n_classes - 1]
        return {
            "iou": iou,
            "precision": precision,
            "recall": recall,
            "iou_ssc": iou_ssc,
            "miou": float(np.mean(iou_ssc)),
        }
