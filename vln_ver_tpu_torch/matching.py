"""Hungarian assignment for DETR-style set matching (PyTorch port of
``vln_ver_tpu/matching.py``).

Two solvers over the same padded-cost contract, both batched: ``cost`` is
``(N, num_query, max_gt)`` with the padded GT columns filled just above the
real maximum (see ``train/objective.py``), and the result is ``(N, max_gt)``,
the query matched to each GT column or -1.

* :func:`hungarian_host`: exact, scipy's ``linear_sum_assignment`` on the
  host, one copy of the whole cost block to the host (the reference moves
  the cost to the CPU and calls scipy, hungarian_assigner_3d.py:124-133).
* :func:`hungarian_auction`: the JAX package's Jacobi auction on the
  device, with a fixed eps from the cost spread and an iteration cap; on
  near-tied costs it can hit the cap, and then the columns still unassigned
  come back -1 (dropped by :func:`build_detr_targets`).  It checks for its
  end every ``_CHECK_EVERY`` iterations: one host sync each time.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.profiling import count

BIG_COST = 1e8
# the auction's iterations between two checks for its end (host syncs)
_CHECK_EVERY = 8


def hungarian_host(cost: torch.Tensor) -> torch.Tensor:
    """(N, nq, G) cost -> (N, G) int64 matched query per GT column, on the
    cost's device; exact (scipy)."""
    from scipy.optimize import linear_sum_assignment
    host = cost.detach().float().cpu().numpy()
    out = np.full(host.shape[::2], -1, np.int64)
    for n, c in enumerate(host):
        rows, cols = linear_sum_assignment(c)
        out[n, cols] = rows
    return torch.from_numpy(out).to(cost.device)


def _auction(cost: torch.Tensor, num_iters: int,
             eps_scale: float) -> torch.Tensor:
    """(N, nq, ng) with ng <= nq -> (N, ng) row of each column, -1 where
    the cap was hit first.  Iteration for iteration the JAX package's
    ``lax.while_loop`` body over the batch; once no column is unassigned an
    iteration changes nothing (every bid is -inf), so checking for the end
    only every ``_CHECK_EVERY`` iterations gives the same result."""
    n, nq, ng = cost.shape
    dev = cost.device
    value = -cost.float().transpose(1, 2)                      # (N, ng, nq)
    spread = torch.clamp_min(value.amax(dim=(1, 2))
                             - value.amin(dim=(1, 2)), 1.0)
    eps = (spread * eps_scale / (ng + 1))[:, None]             # (N, 1)
    prices = torch.zeros(n, nq, device=dev)
    owner_of_row = torch.full((n, nq), -1, dtype=torch.long, device=dev)
    row_of_col = torch.full((n, ng), -1, dtype=torch.long, device=dev)
    rows_idx = torch.arange(nq, device=dev).expand(n, nq)
    drop = torch.full((n, 1), -1, dtype=torch.long, device=dev)
    neg_inf = torch.tensor(-float("inf"), device=dev)
    it = checks = 0
    while it < num_iters:
        for _ in range(min(_CHECK_EVERY, num_iters - it)):
            unassigned = row_of_col < 0                        # (N, ng)
            net = value - prices[:, None, :]                   # (N, ng, nq)
            best = net.argmax(dim=2)                           # (N, ng)
            w1 = net.gather(2, best[..., None])[..., 0]
            w2 = net.scatter(2, best[..., None], -float("inf")).amax(dim=2)
            bid = prices.gather(1, best) + (w1 - w2) + eps
            bid = torch.where(unassigned, bid, neg_inf)
            bids = torch.full((n, ng, nq), -float("inf"), device=dev)
            bids.scatter_(2, best[..., None], bid[..., None])
            row_best_bid = bids.amax(dim=1)                    # (N, nq)
            row_winner = bids.argmax(dim=1)
            got_bid = torch.isfinite(row_best_bid)
            prices = torch.where(got_bid, row_best_bid, prices)
            # evict the previous owners of the rows that changed hands;
            # index ng is a dropped column
            prev_owner = torch.where(got_bid, owner_of_row, -1)
            padded = torch.cat([row_of_col, drop], dim=1)
            padded.scatter_(1, torch.where(prev_owner >= 0, prev_owner, ng),
                            -1)
            owner_of_row = torch.where(got_bid, row_winner, owner_of_row)
            padded.scatter_(1, torch.where(got_bid, row_winner, ng),
                            torch.where(got_bid, rows_idx, -1))
            row_of_col = padded[:, :ng]
            it += 1
        checks += 1
        if not bool((row_of_col < 0).any()):
            break
    count("match#auction_iterations", it)
    count("match#auction_syncs", checks)
    return row_of_col


def hungarian_auction(cost: torch.Tensor, num_iters: int = 500,
                      eps_scale: float = 1e-3) -> torch.Tensor:
    """(N, nq, G) cost -> (N, G) int64 matched query per GT column, on the
    cost's device (minimisation).  With more columns than rows a perfect
    column matching does not exist and the forward auction would never
    end, so the transposed problem is solved (rows bid for columns) and
    turned back (vln_ver_tpu/matching.py:69-82)."""
    n, nq, ng = cost.shape
    if ng > nq:
        col_of_row = _auction(cost.transpose(1, 2), num_iters,
                              eps_scale)                       # (N, nq)
        out = torch.full((n, ng + 1), -1, dtype=torch.long,
                         device=cost.device)
        rows_idx = torch.arange(nq, device=cost.device).expand(n, nq)
        out.scatter_(1, torch.where(col_of_row >= 0, col_of_row, ng),
                     rows_idx)
        return out[:, :ng]
    return _auction(cost, num_iters, eps_scale)


def build_detr_targets(matched_rows: torch.Tensor, gt_valid: torch.Tensor,
                       gt_labels: torch.Tensor, gt_boxes: torch.Tensor,
                       num_query: int, num_classes: int):
    """Scatter matched GT into per-query targets, batched.

    Args:
      matched_rows: (N, G) query index per GT (from a solver), -1 for none.
      gt_valid: (N, G) bool.
      gt_labels: (N, G) int.
      gt_boxes: (N, G, D) target boxes (gravity frame).

    Returns labels (N, num_query) with ``num_classes`` for background,
    bbox_targets (N, num_query, D) and bbox_weights (N, num_query), 1.0 at
    matched queries.  Invalid GTs and negative rows (an auction that hit
    its cap) go to a dropped row, never to query ``num_query - 1``."""
    n = matched_rows.shape[0]
    dev = matched_rows.device
    rows = torch.where(gt_valid & (matched_rows >= 0), matched_rows.long(),
                       num_query)
    labels = torch.full((n, num_query + 1), num_classes, dtype=torch.long,
                        device=dev)
    labels.scatter_(1, rows, gt_labels.long())
    d = gt_boxes.shape[-1]
    targets = torch.zeros((n, num_query + 1, d), dtype=gt_boxes.dtype,
                          device=dev)
    targets.scatter_(1, rows[..., None].expand(n, rows.shape[1], d), gt_boxes)
    weights = torch.zeros((n, num_query + 1), device=dev)
    weights.scatter_(1, rows, 1.0)
    return (labels[:, :num_query], targets[:, :num_query],
            weights[:, :num_query])
