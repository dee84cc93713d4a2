"""The plain reference of a VoxelFormer training step, in fp32.

Written from the published recipe (DefaultRui/VLN-VER: the head's
``loss``, mmdet's ``HungarianAssigner3D``, ``FocalLoss``, ``L1Loss``;
vocc.py's AdamW, gradient clip and cosine schedule with linear warmup):

* per decoder layer, a match of the queries to the boxes under the cost
  2 x focal cost + 0.25 x L1 of the 8 normalised box codes, by the
  configuration's ``matcher``: ``host``, the exact Hungarian assignment
  (scipy's ``linear_sum_assignment``, the published assigner), or
  ``auction``, the Jacobi auction of the JAX package
  (``vln_ver_tpu/matching.py``) that the configuration runs instead,
  with its eps (the cost spread x 1e-3 / (columns + 1)), its iteration
  cap of 500 and its padding of the invalid columns just above the
  largest real cost; then
  the sigmoid focal class loss (alpha 0.25, gamma 2) over every query
  and the L1 box loss of the matched queries (code weights 1 x 8, 0, 0),
  both over the number of valid boxes, weighted 2.0 and 0.25;
* the sigmoid focal occupancy loss over every voxel, over the occupied
  voxels;
* the gradients' global norm clipped to ``grad_clip_norm`` (scale
  ``clip / max(norm, clip)``), then AdamW (b1 0.9, b2 0.999, eps 1e-8,
  decoupled weight decay) at the schedule's rate for the update's index;
* dropout where the published model has it, each mask a Bernoulli draw
  of the default generator of the device in forward order, seeded per
  step from (seed, step) by ``step_seed``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .arch import Arch
from .model import Ref

ALPHA, GAMMA = 0.25, 2.0
CODE_WEIGHTS = (1.0,) * 8 + (0.0, 0.0)


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of update ``step`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def learning_rate(tc: Dict, step: int) -> float:
    """The rate of update ``step`` (from 0): cosine annealing from the
    base rate to base x min_lr_ratio over ``total_steps`` (epoch-granular
    progress with ``steps_per_epoch``), times the linear warmup factor
    ``1 - (1 - t / warmup) (1 - warmup_ratio)`` while t < warmup; in
    float32."""
    f32 = np.float32
    base = tc["learning_rate"]
    min_lr = base * tc["min_lr_ratio"]
    t = f32(step)
    spe = tc["steps_per_epoch"]
    total = f32(max(tc["total_steps"], 1))
    prog = (f32(np.floor(t / f32(spe)) * f32(spe)) / total if spe > 0
            else t / total)
    prog = min(prog, f32(1.0))
    lr = f32(min_lr) + f32(0.5 * (base - min_lr)) * (
        np.cos(f32(math.pi) * prog) + f32(1.0))
    if t < tc["warmup_steps"]:
        warm = f32(max(tc["warmup_steps"], 1))
        lr = lr * (f32(1.0) - (f32(1.0) - t / warm)
                   * f32(1.0 - tc["warmup_ratio"]))
    return float(lr)


def normalize_boxes(b: torch.Tensor) -> torch.Tensor:
    """(..., 9) gravity boxes -> (..., 10) codes (cx, cy, log w, log l,
    cz, log h, sin yaw, cos yaw, vx, vy)."""
    return torch.stack([b[..., 0], b[..., 1], b[..., 3].log(),
                        b[..., 4].log(), b[..., 2], b[..., 5].log(),
                        b[..., 6].sin(), b[..., 6].cos(), b[..., 7],
                        b[..., 8]], dim=-1)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed sigmoid focal loss of (N, C) logits against labels (N,),
    label C meaning no class."""
    c = logits.shape[-1]
    target = torch.zeros_like(logits)
    fg = labels < c
    target[fg.nonzero()[:, 0], labels[fg]] = 1.0
    p = logits.sigmoid()
    pt = (1 - p) * target + p * (1 - target)
    weight = (ALPHA * target + (1 - ALPHA) * (1 - target)) * pt.pow(GAMMA)
    bce = F.binary_cross_entropy_with_logits(logits, target,
                                             reduction="none")
    return (bce * weight).sum()


def match_cost(cls: torch.Tensor, boxes: torch.Tensor, gt_codes, gt_labels):
    """(nq, G) cost of the queries against the boxes."""
    p = cls.sigmoid()
    eps = 1e-12
    neg = -(1 - p + eps).log() * (1 - ALPHA) * p.pow(GAMMA)
    pos = -(p + eps).log() * ALPHA * (1 - p).pow(GAMMA)
    c_cls = (pos - neg)[:, gt_labels]
    c_box = torch.cdist(boxes[:, :8], gt_codes[:, :8], p=1)
    return 2.0 * c_cls + 0.25 * c_box


def auction(cost: np.ndarray, num_iters: int = 500,
            eps_scale: float = 1e-3) -> List[int]:
    """The row won by each column of an (nq, ng) float32 cost, ng <= nq,
    by a forward Jacobi auction: every unassigned column bids for its
    best row at once, each row goes to its highest bidder (the lowest
    column on a tie), evicting its owner; -1 where the cap is reached
    first.  float32, as the program computes it."""
    f32 = np.float32
    value = -cost.T.astype(f32)                              # (ng, nq)
    ng, nq = value.shape
    spread = max(f32(value.max() - value.min()), f32(1.0))
    eps = f32(spread * f32(eps_scale) / f32(ng + 1))
    prices = np.zeros(nq, f32)
    owner = np.full(nq, -1)
    row_of = np.full(ng, -1)
    cols = np.arange(ng)
    for _ in range(num_iters):
        open_ = row_of < 0
        if not open_.any():
            break
        net = value - prices[None, :]
        best = net.argmax(axis=1)
        w1 = net[cols, best]
        masked = net.copy()
        masked[cols, best] = -np.inf
        w2 = masked.max(axis=1)
        bid = np.where(open_, prices[best] + (w1 - w2) + eps, -np.inf)
        bids = np.full((ng, nq), -np.inf, f32)
        bids[cols, best] = bid
        top = bids.max(axis=0)
        winner = bids.argmax(axis=0)
        won = np.isfinite(top)
        prices = np.where(won, top, prices).astype(f32)
        for r in np.nonzero(won)[0]:
            if owner[r] >= 0:
                row_of[owner[r]] = -1
        for r in np.nonzero(won)[0]:
            owner[r] = winner[r]
            row_of[winner[r]] = r
    return [int(r) for r in row_of]


def match(cost: torch.Tensor, valid: torch.Tensor, matcher: str) -> List[int]:
    """The query matched to each box column of an (nq, G) cost, -1 for
    none (an invalid column, or the auction's cap)."""
    c = cost.detach().float()
    if matcher == "host":
        rows = hungarian(c[:, valid])
        out = [-1] * c.shape[1]
        for col, r in zip(valid.nonzero()[:, 0].tolist(), rows):
            out[col] = r
        return out
    if matcher != "auction":
        raise ValueError(f"unknown matcher {matcher!r}")
    real = c[:, valid]
    pad = float(real.max()) + 1.0 if real.numel() else 1.0
    c = torch.where(valid[None, :], c, torch.full_like(c, pad)).cpu().numpy()
    nq, ng = c.shape
    if ng <= nq:
        rows = auction(c)
    else:
        # more columns than queries: the queries bid for the columns
        rows = [-1] * ng
        for r, col in enumerate(auction(c.T)):
            if col >= 0:
                rows[col] = r
    return [r if bool(v) else -1 for r, v in zip(rows, valid.tolist())]


def hungarian(cost: torch.Tensor) -> List[int]:
    """The query matched to each column, exact."""
    from scipy.optimize import linear_sum_assignment
    rows, cols = linear_sum_assignment(cost.detach().double().cpu().numpy())
    out = [-1] * cost.shape[1]
    for r, c in zip(rows, cols):
        out[c] = int(r)
    return out


def losses(a: Arch, outs: Dict, batch: Dict,
           matcher: str = "host") -> torch.Tensor:
    """The summed loss of one batch."""
    cls_all, box_all = outs["all_cls_scores"], outs["all_bbox_preds"]
    nl, b, nq, c = cls_all.shape
    total = cls_all.new_zeros(())
    valid = batch["gt_valid"].bool()
    num_pos = max(float(valid.sum()), 1.0)
    w_code = torch.tensor(CODE_WEIGHTS, device=cls_all.device)
    for layer in range(nl):
        for i in range(b):
            codes = normalize_boxes(batch["gt_boxes"][i].float())
            labels_gt = batch["gt_labels"][i].long()
            cls, box = cls_all[layer, i].float(), box_all[layer, i].float()
            labels = torch.full((nq,), c, dtype=torch.long,
                                device=cls.device)
            l1 = cls.new_zeros(())
            rows = match(match_cost(cls, box, codes, labels_gt), valid[i],
                         matcher)
            pairs = [(r, g) for g, r in enumerate(rows) if r >= 0]
            if pairs:
                r_t = torch.tensor([r for r, _ in pairs], device=cls.device)
                g_t = torch.tensor([g for _, g in pairs], device=cls.device)
                labels[r_t] = labels_gt[g_t]
                l1 = ((box[r_t] - codes[g_t]).abs() * w_code).sum()
            total = total + 2.0 * focal_loss(cls, labels) / num_pos
            total = total + 0.25 * l1 / num_pos
    occ = outs["occupancy_preds"].float()
    gt_occ = batch["occ_dense"].reshape(-1).long()
    occupied = max(float((gt_occ < a.occupancy_classes).sum()), 1.0)
    return total + focal_loss(occ.reshape(-1, occ.shape[-1]),
                              gt_occ) / occupied


class RefTrainer:
    """Parameters (fp32 leaves by the published names), AdamW moments and
    the update count of the reference run."""

    def __init__(self, a: Arch, weights: Dict[str, torch.Tensor], tc: Dict):
        self.a, self.tc = a, tc
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.step = 0

    def drop_fn(self, device, p: float):
        keep = 1.0 - p

        def drop(x):
            mask = torch.empty(x.shape, dtype=x.dtype,
                               device=device).bernoulli_(keep)
            return x * (mask / keep)
        return drop

    def loss_and_grads(self, batch: Dict, seed: int, quant=None,
                       capture=None):
        """The loss of one batch, with the gradients left on the leaves."""
        dev = batch["features"].device
        devices = [dev.index] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(step_seed(seed, self.step))
            ref = Ref(self.a, self.params, quant=quant,
                      drop=self.drop_fn(dev, self.a.dropout_rate))
            outs = ref.forward(batch["features"], batch["world2pixel"],
                               batch["origin_shift"], capture=capture)
            loss = losses(self.a, outs, batch, self.tc["matcher"])
        for p in self.params.values():
            p.grad = None
        loss.backward()
        return loss.detach()

    def update(self) -> Dict[str, torch.Tensor]:
        """Clip and AdamW; returns the gradients as the optimizer took
        them (clipped)."""
        tc = self.tc
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack(
            [g.double().norm() for g in grads.values()]))
        clip = tc["grad_clip_norm"]
        scale = float(clip / max(float(norm), clip))
        lr = learning_rate(tc, self.step)
        wd = tc["weight_decay"]
        t = self.step + 1
        used = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k] * scale
                used[k] = g
                self.m[k].mul_(0.9).add_(g, alpha=0.1)
                self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
                m_hat = self.m[k] / (1 - 0.9 ** t)
                v_hat = self.v[k] / (1 - 0.999 ** t)
                p.mul_(1 - lr * wd)
                p.sub_(lr * m_hat / (v_hat.sqrt() + 1e-8))
        self.step += 1
        return used
