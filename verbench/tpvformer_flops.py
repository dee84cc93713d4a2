"""FLOP and byte formulas of TPVFormer's occupancy frame
(``reference/tpvformer.py``'s architecture), for the ``mfu`` and
``msda_roofline`` metrics of its cells.  A multiply-add is 2 FLOP.

* :func:`frame_flop`: the FLOP one frame's path needs, batch 1: every
  projection, the FFNs, the aggregator's upsampling, MLP and classifier,
  and the deformable samplings at the shapes the program launches them
  (the lift at its capacity, every camera's sub-query slots);
* :func:`msda_launches`: the gather kernel's launches of a frame, in the
  program's order (each layer's hybrid attention, then in the first
  ``cross_layers`` its image cross-attention); their least times are
  ``bevformer_flops.msda_least_s``'s (bytes read and written once, or the
  fp32 operations on the samples, whichever bounds).
"""

from __future__ import annotations

from typing import List

from .bevformer_flops import Launch, msda_flop


def msda_launches(a) -> List[Launch]:
    """The deformable samplings of one frame, in the program's order."""
    h, d = a.num_heads, a.head_dim
    n = a.queries
    out = []
    for i in range(a.encoder_layers):
        out.append(Launch(1, n, h, d, n, 3, a.hybrid_points))
        if i < a.cross_layers:
            out.append(Launch(a.num_cams, a.value_rows, h, d, a.lift_queries,
                              a.num_levels, a.num_points[0]))
    return out


def frame_flop(a) -> float:
    """FLOP of one frame at batch 1."""
    e, h, L, P = a.embed_dims, a.num_heads, a.num_levels, a.hybrid_points
    n = a.queries

    def lin(rows, n_in, n_out):
        return 2.0 * rows * n_in * n_out

    hybrid = (2 * lin(n, e, e)                       # value and output proj
              + lin(n, e, h * 3 * P * 2)             # offsets
              + lin(n, e, h * 3 * (P + 1)))          # logits
    ica = lin(a.num_cams * a.value_rows, e, e) + lin(n, e, e)
    for rows, p in zip(a.plane_lens, a.num_points):
        ica += lin(rows, e, h * L * p * 3)           # offsets and weights
    ffn = 2 * lin(n, e, a.ffn_dim)
    total = a.encoder_layers * (hybrid + ffn) + a.cross_layers * ica
    cells = a.lattice[0] * a.lattice[1] * a.lattice[2]
    total += 2 * lin(cells, e, a.hidden_dims)        # the aggregator's MLP
    total += lin(cells, e, a.num_classes)
    # the bilinear upsampling (4 taps a channel) and the fuse's two adds
    up = sum(4 * s for s in (a.lattice[0] * a.lattice[1],
                             a.lattice[2] * a.lattice[1],
                             a.lattice[0] * a.lattice[2]))
    total += 2.0 * e * up + 2.0 * e * cells
    return total + sum(msda_flop(x) for x in msda_launches(a))
