"""Losses and matching costs with mmdet semantics (PyTorch port of
``vln_ver_tpu/losses.py``).

Reduction convention (mmdet ``weight_reduce_loss``): elementwise loss times
weight, summed, divided by ``max(avg_factor, 1)``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

Factor = Union[float, torch.Tensor]


def _avg(total: torch.Tensor, avg_factor: Factor) -> torch.Tensor:
    return total / torch.clamp_min(torch.as_tensor(
        avg_factor, dtype=torch.float32, device=total.device), 1.0)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       alpha: float = 0.25, gamma: float = 2.0,
                       avg_factor: Optional[Factor] = None,
                       loss_weight: float = 1.0) -> torch.Tensor:
    """mmdet ``py_sigmoid_focal_loss`` with one-hot targets: logits (N, C),
    labels (N,) int with ``C`` for background (an all-zero target),
    optional (N,) weights; ``avg_factor`` defaults to N."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    # labels == C (background) one-hot into a dropped extra column
    target = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes] \
        .float()
    p = logits.sigmoid()
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) \
        * pt.pow(gamma)
    bce = (torch.clamp_min(logits, 0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    loss = bce * focal_weight
    if weight is not None:
        loss = loss * weight[..., None].float()
    if avg_factor is None:
        avg_factor = float(labels.shape[0])
    return loss_weight * _avg(loss.sum(), avg_factor)


def weighted_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                     weight: torch.Tensor, avg_factor: Factor,
                     loss_weight: float = 1.0) -> torch.Tensor:
    """mmdet L1Loss: |pred - target| * weight, summed / avg_factor.  Rows
    whose target is not finite get zero weight (the reference drops them,
    head:969-975; with a weighted sum that is the same)."""
    pred, target = pred.float(), target.float()
    finite = torch.isfinite(target).all(dim=-1, keepdim=True)
    target = torch.where(finite, target, torch.zeros((), device=pred.device))
    weight = weight * finite.float()
    loss = (pred - target).abs() * weight
    return loss_weight * _avg(loss.sum(), avg_factor)


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    weight: Optional[torch.Tensor] = None,
                    avg_factor: Optional[Factor] = None,
                    loss_weight: float = 1.0) -> torch.Tensor:
    """Softmax cross-entropy over C classes (labels in [0, C)): the
    reference's ``occ_loss_type='ce_loss'``, the last class empty."""
    logp = logits.float().log_softmax(dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if weight is not None:
        nll = nll * weight.float()
    if avg_factor is None:
        avg_factor = float(labels.numel())
    return loss_weight * _avg(nll.sum(), avg_factor)


def focal_loss_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0,
                    weight: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """mmdet ``FocalLossCost``: (..., nq, C) logits and (..., G) labels ->
    (..., nq, G) classification cost."""
    p = cls_logits.float().sigmoid()
    neg = -(1.0 - p + eps).log() * (1.0 - alpha) * p.pow(gamma)
    pos = -(p + eps).log() * alpha * (1.0 - p).pow(gamma)
    cost = pos - neg                                        # (..., nq, C)
    idx = gt_labels.long()[..., None, :].expand(
        *cost.shape[:-1], gt_labels.shape[-1])
    return cost.gather(-1, idx) * weight


def bbox_l1_cost(bbox_pred: torch.Tensor, gt_norm_boxes: torch.Tensor,
                 weight: float = 1.0) -> torch.Tensor:
    """mmdet ``BBox3DL1Cost``: pairwise L1 (cdist p=1) of (..., nq, D) and
    (..., G, D) -> (..., nq, G)."""
    diff = (bbox_pred[..., :, None, :] - gt_norm_boxes[..., None, :, :]).abs()
    return diff.sum(dim=-1) * weight
