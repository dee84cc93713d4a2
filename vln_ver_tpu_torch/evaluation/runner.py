"""The evaluation loop: occupancy SSC metrics and indoor detection mAP
(PyTorch port of ``vln_ver_tpu/evaluation/runner.py``).

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
from ..parallel import multihost
from ..parallel.mesh import parse_eval_mesh, shard_views
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


def _gather_rows(rows, n_fields: int, per: int, group):
    """Per-sample tuples of ``n_fields`` arrays from every rank of
    ``group``, in (rank, index) order; every rank enters every gather."""
    fields = [multihost.allgather_results(
        np.stack([r[f] for r in rows]) if rows else np.zeros((0,)), per,
        group) for f in range(n_fields)]
    return list(zip(*fields))


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
    several thresholds), plus ``sca_overflow``.

    ``mesh`` (a ``parallel.mesh.Mesh``; the default under a process group
    of more than one process is the world's ``(world, 1)`` grid; every
    process calls this function) splits the split over the data ranks in contiguous blocks,
    each taking batches of ``batch_size / D`` (which must divide), and
    each viewpoint's cameras over the view ranks (the model is
    ``shard_views``-ed here); the per-sample rows are gathered and the
    histograms summed over the data group, so every rank returns the
    metrics of the whole split."""
    if mesh is None:
        mesh = parse_eval_mesh(None)
    if mesh is not None and batch_size % mesh.data_size:
        raise ValueError(f"batch_size {batch_size} not divisible by the "
                         f"mesh's data size {mesh.data_size}")
    cfg = model.cfg
    device = next(model.parameters()).device
    n = min(len(dataset), limit or len(dataset))
    indices = range(n)
    if mesh is not None:
        batch_size //= mesh.data_size
        indices = multihost.shard_indices(n, mesh.data_index, mesh.data_size)
        model.shard_views(mesh.views)
    n_occ_cls = occupancy_num_classes(cfg.occupancy_classes,
                                      cfg.occ_loss_type)
    ssc = {thr: SSCMetrics(n_occ_cls) for thr in occ_thresholds}
    pred_rows, gt_rows, layout_rows = [], [], []
    overflow = 0
    # dropout off for the eval, as the JAX runner evaluates
    # deterministically; a model in training comes back in training
    was_training = model.training
    model.eval()

    for batch in iterate_batches(dataset, batch_size, indices=indices):
        bsz = batch["features"].shape[0]
        if mesh is not None:
            batch = shard_views(mesh, batch)
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
    if mesh is not None and mesh.distributed:
        per = multihost.shard_size(n, mesh.data_size)
        group = mesh.data_group
        gt_rows = _gather_rows(gt_rows, 3, per, group)
        pred_rows = _gather_rows(pred_rows, 4, per, group)
        layout_rows = list(multihost.allgather_results(
            np.asarray(layout_rows, np.float64), per, group))
        for thr in occ_thresholds:
            ssc[thr].hist = multihost.allreduce_sum(ssc[thr].hist, group)
        overflow = multihost.allreduce_max(overflow, mesh.world_group)

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
