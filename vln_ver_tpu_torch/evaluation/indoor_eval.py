"""Indoor 3D detection evaluation: mAP / mAR at IoU {0.10, 0.25, 0.5, 0.75}
(the port's copy of ``vln_ver_tpu/evaluation/indoor_eval.py``, numpy).

VOC-style AP (reference datasets/indoor_eval.py:8-315) with rotated 3D
IoU: BEV polygon intersection (Sutherland-Hodgman clipping) times the
z-extent overlap.

Box format everywhere: (cx, cy, cz, w, l, h, yaw) with cz at the gravity
centre, w = x-size, l = y-size, yaw about +z.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _bev_corners(box: np.ndarray) -> np.ndarray:
    cx, cy, w, l, yaw = box[0], box[1], box[3], box[4], box[6]
    dx, dy = w / 2, l / 2
    corners = np.array([[dx, dy], [dx, -dy], [-dx, -dy], [-dx, dy]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    return corners @ rot.T + np.array([cx, cy])


def _polygon_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip ``subject`` polygon by convex ``clip``."""
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (
            p[0] - a[0]) >= 0

    def intersect(p1, p2, a, b):
        d1 = p2 - p1
        d2 = b - a
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-12:
            return p2
        t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
        return p1 + t * d1

    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        if not output:
            return np.zeros((0, 2))
        input_list, output = output, []
        prev = input_list[-1]
        for cur in input_list:
            if inside(cur, a, b):
                if not inside(prev, a, b):
                    output.append(intersect(prev, cur, a, b))
                output.append(cur)
            elif inside(prev, a, b):
                output.append(intersect(prev, cur, a, b))
            prev = cur
    return np.asarray(output) if output else np.zeros((0, 2))


def _polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def box3d_iou(box1: np.ndarray, box2: np.ndarray) -> float:
    """Rotated 3D IoU between two (7,) boxes."""
    c1 = _bev_corners(box1)
    c2 = _bev_corners(box2)
    # quick reject
    if (c1[:, 0].max() < c2[:, 0].min() or c2[:, 0].max() < c1[:, 0].min()
            or c1[:, 1].max() < c2[:, 1].min()
            or c2[:, 1].max() < c1[:, 1].min()):
        return 0.0
    # ensure counter-clockwise ordering for the clipper
    def ccw(p):
        return p if _signed_area(p) > 0 else p[::-1]
    inter_area = _polygon_area(_polygon_clip(ccw(c1), ccw(c2)))
    if inter_area <= 0:
        return 0.0
    z1lo, z1hi = box1[2] - box1[5] / 2, box1[2] + box1[5] / 2
    z2lo, z2hi = box2[2] - box2[5] / 2, box2[2] + box2[5] / 2
    z_overlap = max(0.0, min(z1hi, z2hi) - max(z1lo, z2lo))
    inter = inter_area * z_overlap
    v1 = box1[3] * box1[4] * box1[5]
    v2 = box2[3] * box2[4] * box2[5]
    union = v1 + v2 - inter
    return float(inter / union) if union > 0 else 0.0


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """'area' mode AP (mmdet3d indoor_eval default)."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def indoor_eval(gt_annos: Sequence[Dict],
                pred_annos: Sequence[Dict],
                iou_thresholds: Sequence[float] = (0.10, 0.25, 0.5, 0.75),
                classes: Sequence[str] = ()) -> Dict[str, float]:
    """Compute per-class AP/AR at each IoU threshold.

    Args:
      gt_annos: per-sample dicts {boxes (N,7), labels (N,)}.
      pred_annos: per-sample dicts {boxes (M,7), labels (M,), scores (M,)}.

    Returns a flat metric dict: '{cls}_AP_{thr:.2f}', 'mAP_{thr:.2f}',
    'mAR_{thr:.2f}'.
    """
    num_classes = (max((int(g["labels"].max()) for g in gt_annos
                        if len(g["labels"])), default=-1) + 1)
    if classes:
        num_classes = max(num_classes, len(classes))

    # organise by class
    preds_by_class: Dict[int, List] = defaultdict(list)
    gts_by_class: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)
    gt_count: Dict[int, int] = defaultdict(int)
    for si, g in enumerate(gt_annos):
        for c in range(num_classes):
            mask = np.asarray(g["labels"]) == c
            boxes = np.asarray(g["boxes"])[mask]
            gts_by_class[c][si] = boxes
            gt_count[c] += len(boxes)
    for si, p in enumerate(pred_annos):
        labels = np.asarray(p["labels"])
        scores = np.asarray(p["scores"])
        boxes = np.asarray(p["boxes"])
        for j in range(len(labels)):
            preds_by_class[int(labels[j])].append(
                (float(scores[j]), si, boxes[j]))

    # Each detection's (best_iou, best_gi) is THRESHOLD-INDEPENDENT —
    # VOC semantics (reference indoor_eval.py:125-143) argmax over ALL
    # GTs, not over still-unmatched ones — so the O(dets x gts)
    # rotated-IoU work (pure-Python polygon clipping, the dominant eval
    # cost) runs ONCE; each threshold below replays only the cheap
    # greedy matching over the precomputed pairs.
    best_by_class: Dict[int, list] = {}
    for c in range(num_classes):
        rows = []
        for _, si, box in sorted(preds_by_class[c], key=lambda t: -t[0]):
            gt_boxes = gts_by_class[c].get(si, np.zeros((0, 7)))
            best_iou, best_gi = 0.0, -1
            for gi in range(len(gt_boxes)):
                iou = box3d_iou(box, gt_boxes[gi])
                if iou > best_iou:
                    best_iou, best_gi = iou, gi
            rows.append((si, best_iou, best_gi))
        best_by_class[c] = rows

    metrics: Dict[str, float] = {}
    for thr in iou_thresholds:
        aps, ars = [], []
        for c in range(num_classes):
            npos = gt_count[c]
            dets = best_by_class[c]
            if npos == 0:
                continue
            matched: Dict[int, set] = defaultdict(set)
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for di, (si, best_iou, best_gi) in enumerate(dets):
                # a duplicate detection whose best GT is already matched
                # counts FP; it must NOT greedily re-match a weaker
                # second GT (that would inflate TP/AP).  The threshold
                # test is strict (iou_max > thresh), as in the reference.
                if best_gi >= 0 and best_iou > thr \
                        and best_gi not in matched[si]:
                    tp[di] = 1
                    matched[si].add(best_gi)
                else:
                    fp[di] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recalls = ctp / max(npos, 1)
            precisions = ctp / np.maximum(ctp + cfp, 1e-9)
            ap = average_precision(recalls, precisions)
            ar = recalls[-1] if len(recalls) else 0.0
            name = classes[c] if c < len(classes) else f"class_{c}"
            metrics[f"{name}_AP_{thr:.2f}"] = ap
            aps.append(ap)
            ars.append(ar)
        metrics[f"mAP_{thr:.2f}"] = float(np.mean(aps)) if aps else 0.0
        metrics[f"mAR_{thr:.2f}"] = float(np.mean(ars)) if ars else 0.0
    return metrics
