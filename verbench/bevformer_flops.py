"""FLOP and byte formulas of BEVFormer-base video inference
(``reference/bevformer.py``'s architecture), for the ``mfu`` and
``msda_roofline`` metrics of its cells.  A multiply-add is 2 FLOP.

* :func:`frame_flop`: the FLOP one frame's path needs, batch 1: every
  projection and FFN, the decoder's self-attention, the branches, and the
  deformable samplings at the shapes the program launches them (the
  lift at its capacity, every camera's slots);
* :func:`msda_launches` and :func:`msda_least_s`: the gather kernel's
  launches of a frame (6 TSA, 6 lift, 6 decoder at BEVFormer-base) and
  their least time on the card: bytes read and written once, or the fp32
  operations on the samples, whichever bounds.  The value bytes a launch
  needs are its whole map where its taps cover it many times over, else
  its taps' rows (the decoder's 900 queries touch a fraction of the BEV).
"""

from __future__ import annotations

from typing import List, NamedTuple

from .flops import HBM_BYTES_PER_S, PEAK_FLOP_PER_S


class Launch(NamedTuple):
    """One call of the deformable sampling: value (bs, rows, heads, d),
    nq queries, L levels of P points."""
    bs: int
    rows: int
    heads: int
    d: int
    nq: int
    levels: int
    points: int


def msda_launches(a) -> List[Launch]:
    """The deformable samplings of one frame, in the program's order."""
    h, d = a.num_heads, a.head_dim
    bev = a.bev_h * a.bev_w
    out = []
    for _ in range(a.encoder_layers):
        out.append(Launch(2, bev, h, d, bev, 1, a.tsa_num_points))
        out.append(Launch(a.num_cams, a.value_rows, h, d, a.lift_queries,
                          a.num_levels, a.sca_num_points))
    out += [Launch(1, bev, h, d, a.num_query, 1, a.decoder_num_points)
            ] * a.decoder_layers
    return out


def msda_flop(x: Launch) -> float:
    """fp32 operations on the samples: 4 taps x d channels, a multiply-add
    each, for every (slot, query, head, level, point)."""
    return 8.0 * x.d * x.bs * x.nq * x.heads * x.levels * x.points


def msda_bytes(x: Launch, elt: int = 4) -> float:
    """Bytes read and written once: the value rows the taps need (at
    most the whole value), fp32 locations and weights, the output."""
    samples = x.bs * x.nq * x.heads * x.levels * x.points
    value = min(x.bs * x.rows * x.heads, 4 * samples) * x.d * elt
    return value + samples * 3 * 4 + x.bs * x.nq * x.heads * x.d * elt


def msda_least_s(x: Launch, elt: int = 4) -> float:
    return max(msda_bytes(x, elt) / HBM_BYTES_PER_S,
               msda_flop(x) / PEAK_FLOP_PER_S["float32"])


def frame_flop(a) -> float:
    """FLOP of one frame of video inference at batch 1."""
    e, f, h = a.embed_dims, a.ffn_dim, a.num_heads
    bev = a.bev_h * a.bev_w
    nq = a.num_query

    def lin(rows, n_in, n_out):
        return 2.0 * rows * n_in * n_out

    enc = 0.0
    tsa_off = h * 2 * a.tsa_num_points
    enc += lin(2 * bev, e, e)                        # value_proj, both slots
    enc += lin(bev, 2 * e, 3 * tsa_off)              # offsets and weights
    enc += lin(bev, e, e)                            # output_proj
    sca_off = h * a.num_levels * a.sca_num_points
    enc += lin(a.num_cams * a.value_rows, e, e)      # value_proj
    enc += lin(bev, e, 3 * sca_off)                  # offsets and weights
    enc += lin(bev, e, e)                            # output_proj
    enc += 2 * lin(bev, e, f)                        # FFN
    dec = 0.0
    dec += lin(nq, e, 3 * e) + 4.0 * nq * nq * e + lin(nq, e, e)
    dec += lin(bev, e, e)                            # value_proj of the BEV
    dec += lin(nq, e, 3 * h * a.decoder_num_points) + lin(nq, e, e)
    dec += 2 * lin(nq, e, f)
    dec += 2 * lin(nq, e, e) + lin(nq, e, a.num_classes)   # cls branch
    dec += 2 * lin(nq, e, e) + lin(nq, e, a.code_size)     # reg branch
    total = a.encoder_layers * enc + a.decoder_layers * dec
    total += lin(1, a.canbus_dims, e // 2) + lin(1, e // 2, e)
    total += lin(nq, e, 3)                           # reference points
    return total + sum(msda_flop(x) for x in msda_launches(a))
