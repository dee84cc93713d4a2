"""NMS-free box decoding and layout decoding (PyTorch port of
``vln_ver_tpu/coders.py``).

Reference: core/bbox/coders/nms_free_coder.py (top-k over the flattened
sigmoid scores of the last decoder layer, denormalise, post-center-range
filter) and layout_coder.py (the same, scoreless, for layout queries).
Static shapes: ``max_num`` rows plus a validity mask; leading batch
dimensions are allowed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .boxes import denormalize_bbox


class DecodedBoxes(NamedTuple):
    bboxes: torch.Tensor   # (..., max_num, 9) gravity boxes
    scores: torch.Tensor   # (..., max_num)
    labels: torch.Tensor   # (..., max_num) int32
    valid: torch.Tensor    # (..., max_num) bool


def _in_range(boxes: torch.Tensor, value_range: Sequence[float]):
    rng = torch.tensor(value_range, dtype=torch.float32, device=boxes.device)
    return ((boxes[..., :3] >= rng[:3]).all(dim=-1)
            & (boxes[..., :3] <= rng[3:]).all(dim=-1))


def decode_boxes(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                 max_num: int = 50, num_classes: int = 17,
                 post_center_range: Sequence[float] = (
                     -10, -10, -5.0, 10, 10, 5.0),
                 score_threshold: Optional[float] = None) -> DecodedBoxes:
    """Decode the LAST decoder layer (nms_free_coder.py:40-100).

    Args:
      cls_scores: (..., num_query, num_classes) logits.
      bbox_preds: (..., num_query, 10) normalized codes.

    The top ``max_num`` scores come from a stable descending sort, so
    equal scores keep the lower flat index first, as ``jax.lax.top_k``
    does (``torch.topk`` promises no order among ties).
    """
    scores = cls_scores.float().sigmoid().flatten(-2)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[..., :max_num]
    top_scores = torch.gather(scores, -1, idx)
    labels = (idx % num_classes).to(torch.int32)
    codes = torch.gather(bbox_preds, -2, (idx // num_classes)[..., None]
                         .expand(idx.shape + bbox_preds.shape[-1:]))
    boxes = denormalize_bbox(codes)
    valid = _in_range(boxes, post_center_range)
    if score_threshold is not None:
        # the reference lowers the threshold by 0.9x until something
        # passes, and below 0.01 keeps everything (nms_free_coder.py:
        # 64-74); closed form of that loop, the 0.01 escape checked first
        f32 = dict(dtype=torch.float32, device=scores.device)
        thr = torch.tensor(score_threshold, **f32)
        max_s = top_scores.max(dim=-1, keepdim=True).values
        ln09 = torch.log(torch.tensor(0.9, **f32))
        # smallest j >= 1 with max_s >= thr * 0.9^j
        k_pass = torch.clamp(torch.ceil(
            torch.log(max_s.clamp_min(1e-30) / thr) / ln09), min=1.0)
        # smallest j >= 1 with thr * 0.9^j < 0.01 (strict)
        k_esc = torch.clamp(torch.floor(
            torch.log(torch.tensor(0.01, **f32) / thr) / ln09) + 1.0,
            min=1.0)
        strict = top_scores > thr
        eff = thr * torch.pow(torch.tensor(0.9, **f32), k_pass)
        fallback = torch.where(k_esc <= k_pass, torch.ones_like(strict),
                               top_scores >= eff)
        valid = valid & torch.where(strict.any(dim=-1, keepdim=True),
                                    strict, fallback)
    return DecodedBoxes(boxes, top_scores, labels, valid)


def decode_layouts(layout_preds: torch.Tensor,
                   post_center_range: Sequence[float] = (
                       -50, -50, -5.0, 50, 50, 5.0)) -> DecodedBoxes:
    """Scoreless layout decode (layout_coder.py:40-74): every layout
    query of the last layer, denormalised and range-filtered."""
    boxes = denormalize_bbox(layout_preds.float())
    zeros = torch.zeros(boxes.shape[:-1], device=boxes.device)
    return DecodedBoxes(boxes, zeros, zeros.to(torch.int32),
                        _in_range(boxes, post_center_range))
