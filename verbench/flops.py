"""The yardstick's arithmetic: peaks, FLOP of a step, bytes and least
times of the deformable-attention kernels, all from the cell's shapes.

Counted from the shapes with these formulas, never by a counter over the
program, so that a change to the program cannot move them.  Matrix
products count 2 FLOP a multiply-add; layer norms, softmaxes and
activations are not counted.  ``needed=True`` counts the work the path
needs whatever implements it: the lift at its query capacity, the
upsampler's even-grid factorisation (``upsampler_flop``, a copy of
``chip_smoke.upsampler_flop``), the occupancy projection on the even
cells and one bias cell.  ``needed=False`` counts what the plain
reference computes (the dense lift, upsampler and projection), which
``verbench/tests`` hold against ``FlopCounterMode`` over the reference.
A training step counts 3x the forward.
"""

from __future__ import annotations

from .reference.arch import Arch

# NVIDIA's data sheet, H100 SXM, dense rates
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                   "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def upsampler_flop(c, z, h, w, stages):
    """(factorised, dense) FLOP of one viewpoint through the upsampler
    (copy of ``chip_smoke.upsampler_flop``).  The factorisation runs 25
    (y, x) taps for each cell of stage 1's even grid and, summed over the
    four parity slices, for each cell of a later stage's input grid, over
    the in-range z plane pairs (3z - 4 for z > 2); the dense transposed
    convolution runs all 75 taps of every input position."""
    pairs = 3 * z - 4 if z > 2 else z
    cells = h * w * (1 + sum(4 ** (s - 2) for s in range(2, stages + 1)))
    positions = z * h * w * sum(4 ** s for s in range(stages))
    return (2 * c * c * 25 * pairs * cells, 2 * c * c * 75 * positions)


def lift_flop(a: Arch) -> int:
    """The lift (encoder) of one viewpoint: matrix products; the
    bilinear taps are :func:`lift_tap_flop`."""
    e, f, nq, n = a.embed_dims, a.ffn_dim, a.bev_num, a.num_cams
    hp = a.num_heads * a.sca_num_points
    nv = a.feat_h * a.feat_w
    per_layer = (n * nv * e * e + nq * e * hp * 3 + nq * e * e
                 + 2 * nq * e * f)
    return 2 * a.encoder_layers * per_layer


def lift_tap_flop(a: Arch, needed: bool = True) -> int:
    """The lift's bilinear taps: 4 a sampling point, a multiply-add per
    channel, over the query slots a camera attends from."""
    slots = a.lift_queries if needed else a.bev_num
    return (2 * 4 * a.head_dim * a.num_heads * a.sca_num_points * slots
            * a.num_cams * a.encoder_layers)


def decoder_flop(a: Arch) -> int:
    """Decoder, its reference-point head and the class and box branches
    of one viewpoint: matrix products; the trilinear taps are
    :func:`decoder_tap_flop`."""
    e, f, q, h = a.embed_dims, a.ffn_dim, a.num_query, a.num_heads
    hp = h * a.decoder_num_points
    per_layer = (3 * q * e * e + 2 * q * q * e + q * e * e          # self
                 + a.bev_num * e * e + q * e * hp * 4 + q * e * e   # cross
                 + 2 * q * e * f                                    # ffn
                 + q * (e * e * a.num_reg_fcs + e * a.num_classes)  # cls
                 + q * (e * e * a.num_reg_fcs + e * a.code_size))   # reg
    return 2 * (a.decoder_layers * per_layer + q * e * 3)


def decoder_tap_flop(a: Arch) -> int:
    return (2 * 8 * a.head_dim * a.num_heads * a.decoder_num_points
            * a.num_query * a.decoder_layers)


def head_flop(a: Arch, needed: bool = True) -> int:
    """Upsampler, occupancy projection and occupancy MLP of one
    viewpoint."""
    e, od = a.embed_dims, a.occ_dims
    fact, dense = upsampler_flop(e, a.bev_z, a.bev_h, a.bev_w, a.up_stages)
    hy, wx = a.occ_ydim, a.occ_xdim
    cells = (hy // 2) * (wx // 2) + 1 if needed else hy * wx
    if a.bev_z == a.occ_zdim:
        proj = cells * a.bev_z * e * od
    else:
        proj = cells * (a.bev_z * e) * (a.occ_zdim * od)
    mlp = cells * a.occ_zdim * (od * od * a.num_occ_fcs
                                + od * a.occupancy_classes)
    return (fact if needed else dense) + 2 * (proj + mlp)


def forward_flop(a: Arch, needed: bool = True, only_bev: bool = False) -> int:
    """One viewpoint's forward."""
    lift = lift_flop(a) + lift_tap_flop(a, needed)
    if only_bev:
        return lift
    return (lift + decoder_flop(a) + decoder_tap_flop(a)
            + head_flop(a, needed))


def train_flop(a: Arch) -> int:
    """One sample's training step: forward and backward, 3x the forward."""
    return 3 * forward_flop(a, needed=True)


def deform_bytes(a: Arch, batch: int, backward: bool = False) -> int:
    """Bytes one launch of the lift's deformable attention must move at a
    batch: the value, the sampling locations and weights read once and
    the output written once (copy of ``chip_smoke.deform_bound``); the
    backward reads the value, locations, weights and output gradient and
    writes their gradients (``chip_smoke.deform_bwd_bound``).  Value and
    output in the compute dtype, locations and weights in fp32."""
    elt = ELEMENT_BYTES[a.dtype]
    bs = batch * a.num_cams
    value = bs * a.feat_h * a.feat_w * a.embed_dims * elt
    slots = bs * a.lift_queries * a.num_heads * a.sca_num_points
    loc, wgt = slots * 2 * 4, slots * 4
    out = bs * a.lift_queries * a.embed_dims * elt
    if backward:
        return 2 * value + 2 * loc + 2 * wgt + out
    return value + loc + wgt + out


def deform_least_s(a: Arch, batch: int, valid_taps: float,
                   backward: bool = False) -> float:
    """Least seconds of one launch: the larger of its bytes over the HBM
    rate and its fp32 operations over the fp32 rate, with a multiply-add
    a channel for each tap that lands inside the map (two in the
    backward), ``valid_taps`` counted on the reference's own sampling
    locations of the visible queries."""
    flops = valid_taps * a.head_dim * (4 if backward else 2)
    return max(deform_bytes(a, batch, backward) / HBM_BYTES_PER_S,
               flops / PEAK_FLOP_PER_S["float32"])
