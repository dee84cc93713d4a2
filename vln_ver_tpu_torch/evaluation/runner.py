"""The evaluation loop: occupancy SSC metrics and indoor detection mAP
(PyTorch port of ``vln_ver_tpu/evaluation/runner.py``, single process).

Per batch the model runs on its device, the last decoder layer's boxes
(and layouts) are decoded there, and the occupancy logits are decoded and
folded into one confusion histogram per threshold there too: only the
decoded boxes and the (T, n, n) histograms cross to the host, and the raw
logits (504k x 16 fp32 per viewpoint) are never kept.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coders import DecodedBoxes, decode_boxes, decode_layouts
from ..data.mp3d import iterate_batches
from ..occupancy import decode_occupancy, occupancy_num_classes
from .indoor_eval import box3d_iou, indoor_eval
from .ssc_metrics import SSCMetrics, confusion_hist_device


def decode_outputs(outs: dict, cfg
                   ) -> Tuple[Optional[DecodedBoxes], Optional[DecodedBoxes]]:
    """The last decoder layer's boxes (``bbox_max_num`` per sample) and
    layouts, decoded on the outputs' device; None where the model has no
    such branch."""
    dec = ldec = None
    if outs.get("all_cls_scores") is not None:
        dec = decode_boxes(outs["all_cls_scores"][-1],
                           outs["all_bbox_preds"][-1],
                           max_num=cfg.bbox_max_num,
                           num_classes=cfg.num_classes,
                           post_center_range=cfg.post_center_range)
    if outs.get("all_layout_preds") is not None:
        ldec = decode_layouts(outs["all_layout_preds"][-1])
    return dec, ldec


def occupancy_hists(occ_logits: torch.Tensor, gt: torch.Tensor,
                    weight: torch.Tensor, thresholds: Sequence[float],
                    cfg) -> torch.Tensor:
    """(B, V, n') logits, (B, V) ground truth and 0/1 weights -> (T, n, n)
    confusion histograms, one per threshold, on the logits' device."""
    n = occupancy_num_classes(cfg.occupancy_classes, cfg.occ_loss_type)
    return torch.stack([
        confusion_hist_device(
            decode_occupancy(occ_logits, thr, loss_type=cfg.occ_loss_type),
            gt, weight, n)
        for thr in thresholds])


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Repeat the last row up to ``rows`` (the short final batch)."""
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[-1:], rows - a.shape[0], 0)])


def evaluate_model(model, dataset, occ_thresholds: Sequence[float] = (0.25,),
                   limit: Optional[int] = None, batch_size: int = 1,
                   classes: Sequence[str] = (),
                   mesh=None) -> Dict[str, float]:
    """Evaluate ``model`` (a port ``VoxelFormer``, on its device) over
    ``dataset``: anything with ``__len__`` and ``__getitem__`` returning
    the MP3D sample dicts (``features``, ``world2pixel``,
    ``origin_shift`` and the ground truth ``gt_boxes``, ``gt_labels``,
    ``gt_valid``, ``gt_layout``, ``layout_valid``, ``occ_dense``,
    ``occ_visible``).  The short final batch is padded by repeating its
    last sample; the pad rows are dropped from every metric.

    Returns the metric dict of the JAX package's runner: ``mAP_*``,
    ``mAR_*`` and per-class APs, ``layout_iou`` where layouts are
    predicted, and per occupancy threshold ``miou``, ``iou`` (percent),
    ``occ_precision``, ``occ_recall`` (suffixed ``@thr`` when there are
    several thresholds), plus ``sca_overflow``."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh eval (data/view sharding over several cards) is not "
            "ported yet (ROADMAP Queue 1, item 13)")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "multi-process eval (sharded split, gathered results) is not "
            "ported yet (ROADMAP Queue 1, item 13)")
    cfg = model.cfg
    device = next(model.parameters()).device
    n = min(len(dataset), limit or len(dataset))
    n_occ_cls = occupancy_num_classes(cfg.occupancy_classes,
                                      cfg.occ_loss_type)
    ssc = {thr: SSCMetrics(n_occ_cls) for thr in occ_thresholds}
    pred_rows, gt_rows, layout_rows = [], [], []
    overflow = 0
    # dropout off for the eval, as the JAX runner evaluates
    # deterministically; a model in training comes back in training
    was_training = model.training
    model.eval()

    for batch in iterate_batches(dataset, batch_size, indices=range(n)):
        bsz = batch["features"].shape[0]
        inputs = [batch[k] for k in ("features", "world2pixel",
                                     "origin_shift")]
        if bsz < batch_size:
            inputs = [_pad_rows(a, batch_size) for a in inputs]
        with torch.inference_mode():
            outs = model(*(torch.from_numpy(np.ascontiguousarray(a))
                           .to(device) for a in inputs))
            dec, ldec = decode_outputs(outs, cfg)
            hists = None
            occ = outs["occupancy_preds"]
            if occ is not None and "occ_dense" in batch:
                # the dense GT encodes empty as ``occupancy_classes``, the
                # ce decode as the last channel: map the one onto the other
                # (a no-op in focal mode)
                gt = np.minimum(np.asarray(batch["occ_dense"]),
                                n_occ_cls - 1)
                w = ((np.asarray(batch["occ_visible"]) == 1)
                     .astype(np.int32) if "occ_visible" in batch
                     else np.ones_like(gt, np.int32))
                if bsz < occ.shape[0]:        # zero-weight pad rows
                    gt = _pad_rows(gt, occ.shape[0])
                    w = np.concatenate([w, np.zeros(
                        (occ.shape[0] - bsz,) + w.shape[1:], np.int32)])
                hists = occupancy_hists(
                    occ, torch.from_numpy(gt).to(device),
                    torch.from_numpy(w).to(device), occ_thresholds, cfg)
        overflow = max(overflow, int(outs["sca_overflow"]))
        if hists is not None:
            h = hists.cpu().numpy().astype(np.float64)
            for t, thr in enumerate(occ_thresholds):
                ssc[thr].hist += h[t]
        if ldec is not None and "gt_layout" in batch:
            lb = ldec.bboxes.cpu().numpy()
            lv = ldec.valid.cpu().numpy()
            for i in range(bsz):
                if not bool(np.asarray(batch["layout_valid"][i]).any()):
                    layout_rows.append(np.nan)
                    continue
                gtl = np.asarray(batch["gt_layout"][i][0][:7])
                ious = [box3d_iou(b[:7], gtl)
                        for b, v in zip(lb[i], lv[i]) if v]
                layout_rows.append(max(ious) if ious else 0.0)
        if dec is not None and "gt_boxes" in batch:
            fields = [f.cpu().numpy() for f in dec]
            for i in range(bsz):
                gt_rows.append((
                    np.asarray(batch["gt_boxes"][i], np.float32),
                    np.asarray(batch["gt_labels"][i], np.int32),
                    np.asarray(batch["gt_valid"][i], bool)))
                pred_rows.append(tuple(f[i] for f in fields))
    model.train(was_training)

    metrics: Dict[str, float] = {"sca_overflow": float(overflow)}
    if gt_rows:
        gt_annos = [{"boxes": b[v][:, :7], "labels": l[v]}
                    for (b, l, v) in gt_rows]
        pred_annos = [{"boxes": b[v][:, :7], "labels": l[v],
                       "scores": s[v]}
                      for (b, s, l, v) in pred_rows]
        metrics.update(indoor_eval(gt_annos, pred_annos,
                                   classes=tuple(classes)))
    layout_vals = [float(x) for x in layout_rows if np.isfinite(x)]
    if layout_vals:
        metrics["layout_iou"] = float(np.mean(layout_vals))
    for thr in occ_thresholds:
        stats = ssc[thr].get_stats()
        suffix = f"@{thr:.2f}" if len(occ_thresholds) > 1 else ""
        metrics[f"miou{suffix}"] = stats["miou"]
        metrics[f"iou{suffix}"] = float(stats["iou"])
        metrics[f"occ_precision{suffix}"] = float(stats["precision"])
        metrics[f"occ_recall{suffix}"] = float(stats["recall"])
    return metrics
