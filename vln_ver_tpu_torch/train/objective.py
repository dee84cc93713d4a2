"""Multi-task training objective: per-decoder-layer DETR losses and
occupancy (PyTorch port of ``vln_ver_tpu/train/objective.py``).

Mirrors VoxelFormerOccupancyHead.loss (head:1105-1444):

* per decoder layer: Hungarian match, then the focal class loss and the
  weighted L1 box loss (code weights [1]*8+[0,0]), both averaged by the
  number of valid GTs;
* the occupancy focal (or softmax CE) loss, averaged by the occupied
  voxels;
* the layout L1 on the LAST decoder layer only (a reference quirk, see
  below).

Batch contract (tensors on the model's device): features (B, cams, fh, fw,
C); world2pixel (B, cams, 4, 4); origin_shift (B, 3); gt_boxes (B, G, 9)
gravity boxes; gt_labels (B, G) int; gt_valid (B, G) bool; occ_dense
(B, voxel_num) int labels (empty = occupancy_classes); optional gt_layout
(B, 1, 9) and layout_valid (B, 1).

All decoder layers are matched in one call of the matcher: the host
matcher copies one (layers * B, nq, G) cost block to the host per step.

Inside ``parallel.mesh.data_parallel`` the batch is this rank's rows of a
global batch: each avg factor (``num_pos``, ``n_lay``, ``num_occupied``)
is summed over the data group before the divide, as the reference's
``reduce_mean`` (and JAX's loss over the global batch) has it.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import losses as L
from ..boxes import normalize_bbox
from ..matching import (BIG_COST, build_detr_targets, hungarian_auction,
                        hungarian_host)
from ..models.config import VERConfig
from ..parallel.mesh import data_size, global_count
from ..utils.profiling import span

CODE_WEIGHTS = (1.0,) * 8 + (0.0, 0.0)


def _match(cls_scores, bbox_preds, gt_norm, gt_labels, gt_valid,
           matcher: str) -> torch.Tensor:
    """Hungarian match of (N, nq, C) scores and (N, nq, 10) boxes against
    (N, G, 10) normalised GTs -> (N, G) matched query per GT.  Without
    ``cls_scores`` the cost is the box term alone (the layout match)."""
    cost = L.bbox_l1_cost(bbox_preds[..., :8], gt_norm[..., :8], weight=0.25)
    if cls_scores is not None:
        cost = L.focal_loss_cost(cls_scores, gt_labels, weight=2.0) + cost
    cost = torch.nan_to_num(cost, nan=BIG_COST, posinf=BIG_COST,
                            neginf=-BIG_COST)
    # Pad the invalid GT columns JUST above the worst real cost of each
    # sample: any pad >= the real maximum gives the same assignment under
    # an exact solver, but the auction's eps scales with the cost spread
    # (vln_ver_tpu/train/objective.py:57-68)
    valid = gt_valid[:, None, :]
    real_max = torch.where(valid, cost, -float("inf")).amax(dim=(1, 2))
    pad = torch.where(torch.isfinite(real_max), real_max + 1.0,
                      torch.ones_like(real_max))
    # the reference detaches the cost before matching
    # (hungarian_assigner_3d.py:125)
    cost = torch.where(valid, cost, pad[:, None, None]).detach()
    if matcher == "host":
        with span("train#match"):
            return hungarian_host(cost)
    if matcher == "auction":
        with span("train#match"):
            return hungarian_auction(cost)
    raise ValueError(f"unknown matcher {matcher!r}: 'auction' or 'host'")


def _rep(t: torch.Tensor, nl: int) -> torch.Tensor:
    """(B, ...) -> (nl * B, ...), layer-major."""
    return t[None].expand(nl, *t.shape).reshape(nl * t.shape[0],
                                                *t.shape[1:])


def detection_matches(all_cls: torch.Tensor, all_bbox: torch.Tensor,
                      batch: Dict, matcher: str = "auction") -> torch.Tensor:
    """The Hungarian match of every decoder layer at once: (layers, B, nq,
    C) scores and (layers, B, nq, 10) boxes -> (layers * B, G), the query
    matched to each GT box (-1 for none), layer-major."""
    nl, b, nq, _ = all_cls.shape
    gt_valid = batch["gt_valid"].bool()
    return _match(all_cls.reshape(nl * b, nq, -1),
                  all_bbox.reshape(nl * b, nq, -1),
                  _rep(normalize_bbox(batch["gt_boxes"]), nl),
                  _rep(batch["gt_labels"], nl), _rep(gt_valid, nl), matcher)


def _det_losses(cfg: VERConfig, all_cls, all_bbox, batch, matcher: str):
    """(layers, B, nq, C) scores and (layers, B, nq, 10) boxes -> per layer
    (loss_cls, loss_bbox) (head loss_single :903-990)."""
    nl, b, nq, _ = all_cls.shape
    gt_boxes, gt_labels = batch["gt_boxes"], batch["gt_labels"]
    gt_valid = batch["gt_valid"].bool()
    matched = detection_matches(all_cls, all_bbox, batch, matcher)
    labels, targets, bbox_w = build_detr_targets(
        matched, _rep(gt_valid, nl), _rep(gt_labels, nl), _rep(gt_boxes, nl),
        cfg.num_query, cfg.num_classes)
    num_pos = torch.clamp_min(global_count(gt_valid.float().sum()), 1.0)
    code_w = torch.tensor(CODE_WEIGHTS, device=all_bbox.device)
    tgt_norm = normalize_bbox(targets).reshape(nl, b * nq, -1)
    weights = (bbox_w[..., None] * code_w).reshape(nl, b * nq, -1)
    labels = labels.reshape(nl, b * nq)
    out = []
    for lyr in range(nl):
        loss_cls = L.sigmoid_focal_loss(
            all_cls[lyr].reshape(-1, cfg.num_classes), labels[lyr],
            avg_factor=num_pos, loss_weight=cfg.loss_cls_weight)
        loss_bbox = L.weighted_l1_loss(
            all_bbox[lyr].reshape(-1, cfg.code_size), tgt_norm[lyr],
            weights[lyr], avg_factor=num_pos,
            loss_weight=cfg.loss_bbox_weight)
        out.append((torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox)))
    return out


def compute_losses(cfg: VERConfig, outs: Dict, batch: Dict,
                   matcher: str = "auction") -> Dict[str, torch.Tensor]:
    """The loss dict with the reference's keys: ``d{i}.loss_cls`` /
    ``d{i}.loss_bbox`` for the earlier decoder layers, ``loss_cls`` /
    ``loss_bbox`` for the last, ``loss_layout``, ``loss_occupancy`` and
    ``loss_flow`` (the constant 0), each as the model's config has it."""
    loss_dict: Dict[str, torch.Tensor] = {}

    if not cfg.only_occ:
        layers = _det_losses(cfg, outs["all_cls_scores"],
                             outs["all_bbox_preds"], batch, matcher)
        for lyr, (lc, lb) in enumerate(layers):
            prefix = "" if lyr == len(layers) - 1 else f"d{lyr}."
            loss_dict[f"{prefix}loss_cls"] = lc
            loss_dict[f"{prefix}loss_bbox"] = lb

        if cfg.add_layout and outs.get("all_layout_preds") is not None:
            # REFERENCE QUIRK, kept on purpose: the reference computes
            # per-layer layout losses but keys only the last one
            # (voxelformer_occupancy_head.py:1232-1243), so the earlier
            # layers get no layout gradient
            # (vln_ver_tpu/train/objective.py:133-162).
            gt_layout = batch["gt_layout"]                  # (B, 1, 9)
            layout_valid = batch["layout_valid"].bool()     # (B, 1)
            last = outs["all_layout_preds"][-1]             # (B, nq, 10)
            zeros = torch.zeros(layout_valid.shape, dtype=torch.long,
                                device=last.device)
            matched = _match(None, last, normalize_bbox(gt_layout), zeros,
                             layout_valid, matcher)
            _, lay_targets, lay_w = build_detr_targets(
                matched, layout_valid, zeros, gt_layout, cfg.num_query, 1)
            n_lay = torch.clamp_min(
                global_count(layout_valid.float().sum()), 1.0)
            code_w = torch.tensor(CODE_WEIGHTS, device=last.device)
            weights = lay_w[..., None] * code_w
            loss_dict["loss_layout"] = torch.nan_to_num(L.weighted_l1_loss(
                last.reshape(-1, cfg.code_size),
                normalize_bbox(lay_targets).reshape(-1, cfg.code_size),
                weights.reshape(-1, cfg.code_size), avg_factor=n_lay,
                loss_weight=cfg.loss_layout_weight))

    if not cfg.only_det and outs.get("occupancy_preds") is not None:
        occ_preds = outs["occupancy_preds"]                 # (B, n_vox, C)
        gt_occ = batch["occ_dense"].reshape(-1).long()
        num_occupied = global_count(
            (gt_occ < cfg.occupancy_classes).float().sum())
        if cfg.occ_loss_type == "ce_loss":
            # the last channel is empty; the labels already use
            # occupancy_classes for empty
            occ_logits = occ_preds.reshape(-1, occ_preds.shape[-1])
            loss_occ = L.softmax_ce_loss(
                occ_logits, torch.clamp_max(gt_occ, occ_logits.shape[-1] - 1),
                avg_factor=num_occupied, loss_weight=cfg.loss_occ_weight)
        else:
            loss_occ = L.sigmoid_focal_loss(
                occ_preds.reshape(-1, cfg.occupancy_classes), gt_occ,
                avg_factor=num_occupied, loss_weight=cfg.loss_occ_weight)
        loss_dict["loss_occupancy"] = torch.nan_to_num(loss_occ)
        loss_dict["loss_flow"] = torch.zeros((), device=occ_preds.device)

    if data_size() > 1:
        # this rank's share of the global loss, times D: the mean over the
        # data ranks (of the losses and of their gradients) is the global
        # batch's loss
        loss_dict = {k: v * data_size() for k, v in loss_dict.items()}
    return loss_dict
