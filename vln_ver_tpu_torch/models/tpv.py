"""TPVFormer's occupancy model (Huang et al., "Tri-Perspective View for
Vision-Based 3D Semantic Occupancy Prediction", CVPR 2023;
wzzheng/TPVFormer ``config/tpv04_occupancy.py`` with the ``tpvformer04``
modules), from the image neck's output to the semantic occupancy logits.

Three orthogonal planes of queries, HW (tpv_h x tpv_w), ZH (tpv_z x
tpv_h) and WZ (tpv_w x tpv_z), flattened row-major and concatenated in
that order, go through ``encoder_layers`` layers, the first
``cross_layers`` of (hybrid attention, norm, image cross-attention, norm,
FFN, norm), the rest of (hybrid attention, norm, FFN, norm).  Norms and
FFNs are shared by the planes; every attention has a projection per
plane.

* :class:`TPVCrossViewHybridAttention`: each plane's queries sample all
  three planes, read as three levels of one value; a point's weight is the
  softmax over its level's points times the softmax over the levels of one
  extra logit a level.  Reference points (:func:`cross_view_ref_points`):
  ``hybrid_anchors`` a level, the query's own cell on its plane, and on
  each other plane points evenly spaced along the axis the query's plane
  lacks; each anchor takes ``hybrid_points / hybrid_anchors`` of the
  points (upstream's anchor-major view).
* :class:`TPVImageCrossAttention`: each query lifts from the cameras that
  see any of its pillar's anchors, as BEVFormer's spatial cross-attention
  does, through the port's shared sparse lift.  An HW pillar has
  ``num_points_in_pillar[0]`` anchors along z; a ZH or WZ pillar
  ``num_points_in_pillar[1 or 2]`` along the axis its plane lacks, cut
  into groups of ``num_points_in_pillar[0]`` anchors with
  ``num_points[0]`` points a level each (upstream's ``points_multiplier``
  sub-queries), whose outputs are summed.  The sampling runs over
  sub-query slots: a camera takes each visible query's groups, so one
  gather launch a layer serves the three planes at one anchor count.
* :class:`TPVAggregator`: each plane upsampled ``scale`` times
  (``F.interpolate``, bilinear, ``align_corners=False``), the three summed
  at every cell of the (W, H, Z) lattice, then Linear, Softplus, Linear
  and the classifier; logits ``(B, classes, W, H, Z)`` as upstream's
  permute gives them.

On the card every sampling takes the gather kernel (``csrc/msda_gather.cu``
at head_dim 16, its narrow lane layout), which has no backward: a card
forward that needs a gradient raises (``ops.deform_cuda``).

Departures from upstream: the sparse lift's static capacity
(``ica_query_capacity``, in sub-query slots a camera; upstream rebatches
to each frame's ``max_len``), equal to upstream's rebatch wherever no
camera has more visible slots; weights from :func:`build_tpvformer` are
random (module names follow upstream's ``state_dict``, so a checkpoint of
``tpv_head`` and ``tpv_aggregator`` loads).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import geometry
from ..ops.deform_cuda import ms_deform_attn_2d_fused
from ..utils.profiling import count, span
from .attention import _offset_grid_init_2d, lift_overflow, lift_slots
from .encoder import FFN
from .head import Embedding, _UniformTable
from .layers import Dense, Dropout, LayerNorm

NUSCENES_PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


@dataclasses.dataclass(frozen=True)
class TPVConfig:
    tpv_h: int = 100
    tpv_w: int = 100
    tpv_z: int = 8
    embed_dims: int = 128
    num_heads: int = 8
    # the positional tables' widths, (h, w, z); they sum to embed_dims
    pos_dims: Tuple[int, int, int] = (48, 48, 32)
    ffn_dim: int = 256
    num_levels: int = 4
    num_cams: int = 6
    # the neck's levels, (h, w) each, finest first
    feat_shapes: Tuple[Tuple[int, int], ...] = (
        (116, 200), (58, 100), (29, 50), (15, 25))
    encoder_layers: int = 5
    # the first layers that also lift from the cameras
    cross_layers: int = 3
    # pillar anchors and points a level of each plane's query (HW, ZH, WZ)
    num_points_in_pillar: Tuple[int, int, int] = (4, 32, 32)
    num_points: Tuple[int, int, int] = (8, 64, 64)
    # the hybrid attention's anchors and points a level
    hybrid_anchors: int = 16
    hybrid_points: int = 32
    scale_h: int = 2
    scale_w: int = 2
    scale_z: int = 2
    num_classes: int = 18
    # the aggregator's hidden width
    hidden_dims: int = 256
    pc_range: Tuple[float, ...] = NUSCENES_PC_RANGE
    # the padded image that normalises pixel coordinates, (w, h)
    image_wh: Tuple[float, float] = (1600.0, 928.0)
    # the sparse lift's sub-query slots a camera; 0: the dense lift
    ica_query_capacity: int = 0
    layer_norm_eps: float = 1e-5
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.feat_shapes) != self.num_levels:
            raise ValueError(f"feat_shapes {self.feat_shapes} name "
                             f"{len(self.feat_shapes)} levels, num_levels "
                             f"is {self.num_levels}")
        if sum(self.pos_dims) != self.embed_dims:
            raise ValueError(f"pos_dims {self.pos_dims} must sum to "
                             f"embed_dims {self.embed_dims}")
        base_a, base_p = self.num_points_in_pillar[0], self.num_points[0]
        for a, p in zip(self.num_points_in_pillar, self.num_points):
            if a % base_a or p * base_a != base_p * a:
                raise ValueError(
                    f"pillars {self.num_points_in_pillar} and points "
                    f"{self.num_points}: every plane's anchors must cut "
                    f"into groups of {base_a} with {base_p} points a level")
        if base_p % base_a or self.hybrid_points % self.hybrid_anchors:
            raise ValueError("points must share out evenly over anchors")
        if not 0 < self.cross_layers <= self.encoder_layers:
            raise ValueError(f"cross_layers {self.cross_layers} outside "
                             f"(0, {self.encoder_layers}]")

    @property
    def plane_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """(rows, columns) of the HW, ZH and WZ planes: the hybrid
        attention's three levels."""
        return ((self.tpv_h, self.tpv_w), (self.tpv_z, self.tpv_h),
                (self.tpv_w, self.tpv_z))

    @property
    def plane_lens(self) -> Tuple[int, int, int]:
        return tuple(h * w for h, w in self.plane_shapes)

    @property
    def groups(self) -> Tuple[int, int, int]:
        """Sub-queries of each plane's query in the image cross-attention
        (upstream's ``points_multiplier``)."""
        return tuple(a // self.num_points_in_pillar[0]
                     for a in self.num_points_in_pillar)

    @property
    def lattice(self) -> Tuple[int, int, int]:
        """(W, H, Z) of the logits' lattice."""
        return (self.tpv_w * self.scale_w, self.tpv_h * self.scale_h,
                self.tpv_z * self.scale_z)


def _centres(n: int, device=None) -> torch.Tensor:
    return torch.linspace(0.5, n - 0.5, n, device=device) / n


def _spread(n: float, k: int, device=None) -> torch.Tensor:
    """``k`` points evenly over an axis of extent ``n``, normalised."""
    return torch.linspace(0.5, n - 0.5, k, device=device) / n


def _grid(*axes: torch.Tensor) -> List[torch.Tensor]:
    """Each 1-D ``axes[i]`` laid along dimension i of their joint grid."""
    return list(torch.meshgrid(*axes, indexing="ij"))


def pillar_points(cfg: TPVConfig, device=None) -> List[torch.Tensor]:
    """Each plane's pillar anchors, normalised world (x, y, z) in [0, 1]:
    HW (h*w, A0, 3) along z; ZH (z*h, A1, 3) along x; WZ (w*z, A2, 3)
    along y (upstream ``TPVFormerEncoder.get_reference_points`` and its
    axis permutations).  The h axis is y, the w axis x."""
    H, W, Z = cfg.tpv_h, cfg.tpv_w, cfg.tpv_z
    a_hw, a_zh, a_wz = cfg.num_points_in_pillar
    pc = cfg.pc_range
    hw = geometry.pillar_reference_points(H, W, a_hw, z_extent=pc[5] - pc[2],
                                          device=device)
    hc, wc, zc = (_centres(n, device) for n in (H, W, Z))
    z, h, x = _grid(zc, hc, _spread(pc[3] - pc[0], a_zh, device))
    zh = torch.stack([x, h, z], -1).reshape(Z * H, a_zh, 3)
    w, z, y = _grid(wc, zc, _spread(pc[4] - pc[1], a_wz, device))
    wz = torch.stack([w, y, z], -1).reshape(W * Z, a_wz, 3)
    return [hw, zh, wz]


def cross_view_ref_points(cfg: TPVConfig, device=None) -> torch.Tensor:
    """(hw + zh + wz, 3, A, 2) reference points of the hybrid attention,
    normalised (x, y) on each of the three planes read as maps (HW: x = w,
    y = h; ZH: x = h, y = z; WZ: x = z, y = w): upstream's
    ``get_cross_view_ref_points`` with ``hybrid_anchors`` points in every
    pillar, the query's own cell on its plane and points spread along the
    axis its plane lacks on the other two."""
    H, W, Z, A = cfg.tpv_h, cfg.tpv_w, cfg.tpv_z, cfg.hybrid_anchors
    hc, wc, zc = (_centres(n, device) for n in (H, W, Z))
    hs, ws, zs = (_spread(n, A, device) for n in (H, W, Z))

    def plane(levels):
        return torch.stack([torch.stack(xy, -1).reshape(-1, A, 2)
                            for xy in levels], 1)

    h, w, zk = _grid(hc, wc, zs)                     # HW query (h, w)
    hw = plane([(w, h), (h, zk), (zk, w)])
    z, h, wk = _grid(zc, hc, ws)                     # ZH query (z, h)
    zh = plane([(wk, h), (h, z), (z, wk)])
    w, z, hk = _grid(wc, zc, hs)                     # WZ query (w, z)
    wz = plane([(w, hk), (hk, z), (z, w)])
    return torch.cat([hw, zh, wz], 0)


def max_visible_slots(world2pixel: np.ndarray, cfg: TPVConfig) -> int:
    """The most sub-query slots any camera's lift needs: for each camera
    the visible HW queries plus ``groups`` times the visible ZH and WZ
    queries, each visible where any anchor of its pillar is; the least safe
    ``ica_query_capacity``.  Pure numpy on the host, in float64 with the
    image bounds dilated by 1e-4 (``geometry.max_visible_queries``'s
    rule), so it never under-counts."""
    w2p = np.asarray(world2pixel, np.float64).reshape(-1, 4, 4)
    pc = np.asarray(cfg.pc_range, np.float32)
    need = np.zeros(w2p.shape[0], np.int64)
    tol, eps = 1e-4, 1e-5
    for pts, g in zip(pillar_points(cfg), cfg.groups):
        ref = pts.numpy().astype(np.float32)
        world = ref * (pc[3:6] - pc[0:3]) + pc[0:3]
        homo = np.concatenate([world, np.ones_like(world[..., :1])], -1)
        cam = np.einsum("cij,qaj->cqai", w2p, homo.astype(np.float64))
        depth = cam[..., 2]
        xy = cam[..., 0:2] / np.maximum(depth, eps)[..., None]
        xy = xy / np.asarray(cfg.image_wh, np.float64)
        vis = ((depth > eps * (1.0 - tol))
               & (xy[..., 0] > -tol) & (xy[..., 0] < 1.0 + tol)
               & (xy[..., 1] > -tol) & (xy[..., 1] < 1.0 + tol)).any(-1)
        need += g * vis.sum(-1)
    return int(need.max())


def hybrid_weights(logits: torch.Tensor) -> torch.Tensor:
    """The hybrid attention's weights from its (..., 3, P + 1) logits: the
    softmax over a level's P points times the softmax over the 3 levels of
    the extra logit, (..., 3, P), contiguous."""
    p = logits.shape[-1] - 1
    return (logits[..., :p].softmax(-1)
            * logits[..., p:].softmax(-2)).contiguous()


class TPVPositionalEncoding(nn.Module):
    """Upstream's ``CustomPositionalEncoding``: learned h, w and z tables
    of ``pos_dims`` features, concatenated in the order (h, w, z) with
    zeros for the axis a plane lacks."""

    def __init__(self, cfg: TPVConfig):
        super().__init__()
        fh, fw, fz = cfg.pos_dims
        self.h_embed = _UniformTable(cfg.tpv_h, fh)
        self.w_embed = _UniformTable(cfg.tpv_w, fw)
        self.z_embed = _UniformTable(cfg.tpv_z, fz)

    def forward(self) -> torch.Tensor:
        """(hw + zh + wz, embed_dims), the planes concatenated."""
        h, w, z = self.h_embed.weight, self.w_embed.weight, \
            self.z_embed.weight
        H, W, Z = h.shape[0], w.shape[0], z.shape[0]
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        hw = torch.cat([h[:, None].expand(H, W, -1),
                        w[None].expand(H, W, -1),
                        zero.expand(H, W, z.shape[1])], -1)
        zh = torch.cat([h[None].expand(Z, H, -1),
                        zero.expand(Z, H, w.shape[1]),
                        z[:, None].expand(Z, H, -1)], -1)
        wz = torch.cat([zero.expand(W, Z, h.shape[1]),
                        w[:, None].expand(W, Z, -1),
                        z[None].expand(W, Z, -1)], -1)
        return torch.cat([hw.reshape(H * W, -1), zh.reshape(Z * H, -1),
                          wz.reshape(W * Z, -1)], 0)


class TPVCrossViewHybridAttention(nn.Module):
    """Upstream's ``TPVCrossViewHybridAttention``: per plane a value
    projection, offsets (heads x 3 levels x points x 2), logits (heads x
    3 x (points + 1)) and an output projection; dropout and the residual
    per plane."""

    def __init__(self, cfg: TPVConfig):
        super().__init__()
        e, h, p = cfg.embed_dims, cfg.num_heads, cfg.hybrid_points
        self.cfg = cfg
        self.num_heads, self.num_points = h, p
        self.num_anchors = cfg.hybrid_anchors
        dt = cfg.dtype
        self.sampling_offsets = nn.ModuleList(
            [Dense(e, h * 3 * p * 2) for _ in range(3)])
        self.attention_weights = nn.ModuleList(
            [Dense(e, h * 3 * (p + 1)) for _ in range(3)])
        self.value_proj = nn.ModuleList([Dense(e, e, dt) for _ in range(3)])
        self.output_proj = nn.ModuleList([Dense(e, e, dt) for _ in range(3)])
        self.dropout = nn.ModuleList([Dropout(cfg.dropout_rate)
                                      for _ in range(3)])
        # (W, H) of each plane, on the module's device: no host-to-device
        # copy in the forward
        self.register_buffer("normalizer", torch.tensor(
            [[w, h] for h, w in cfg.plane_shapes], dtype=torch.float32),
            persistent=False)

    @torch.no_grad()
    def init_sampling(self) -> None:
        """Zero kernels, a directional grid as the offsets' bias, zero
        logits."""
        h, p = self.num_heads, self.num_points
        grid = _offset_grid_init_2d(h, 3, p)
        for off, att in zip(self.sampling_offsets, self.attention_weights):
            off.weight.zero_()
            off.bias.copy_(grid)
            att.weight.zero_()
            att.bias.zero_()

    def forward(self, query: torch.Tensor, pos: torch.Tensor,
                ref: torch.Tensor) -> torch.Tensor:
        """query (B, N, C) the three planes concatenated; pos (N, C) or
        (B, N, C); ref (N, 3, A, 2) (:func:`cross_view_ref_points`)."""
        cfg = self.cfg
        bsz, n, e = query.shape
        heads, P, A = self.num_heads, self.num_points, self.num_anchors
        lens = cfg.plane_lens
        q = (query + pos).split(lens, 1)
        value = torch.cat([proj(x) for proj, x in zip(self.value_proj, q)],
                          1).reshape(bsz, n, heads, e // heads)
        offsets = torch.cat([
            fc(x.float()).reshape(bsz, x.shape[1], heads, 3, P, 2)
            for fc, x in zip(self.sampling_offsets, q)], 1)
        logits = torch.cat([
            fc(x.float()).reshape(bsz, x.shape[1], heads, 3, P + 1)
            for fc, x in zip(self.attention_weights, q)], 1)
        weights = hybrid_weights(logits)
        shapes = cfg.plane_shapes
        offsets = (offsets / self.normalizer[:, None, :]).reshape(
            bsz, n, heads, 3, A, P // A, 2)
        loc = (ref.float()[:, None, :, :, None, :] + offsets).reshape(
            bsz, n, heads, 3, P, 2)
        out = ms_deform_attn_2d_fused(value.float().contiguous(), shapes,
                                      loc.contiguous(), weights)
        outs = out.to(cfg.dtype).split(lens, 1)
        ids = query.split(lens, 1)
        return torch.cat([x + drop(proj(o)) for x, o, proj, drop in zip(
            ids, outs, self.output_proj, self.dropout)], 1)


class TPVMSDeformableAttention3D(nn.Module):
    """Upstream's ``TPVMSDeformableAttention3D``: offsets and weights per
    plane, one value projection; no output projection."""

    def __init__(self, cfg: TPVConfig):
        super().__init__()
        e, h, L = cfg.embed_dims, cfg.num_heads, cfg.num_levels
        self.cfg = cfg
        self.sampling_offsets = nn.ModuleList(
            [Dense(e, h * L * p * 2) for p in cfg.num_points])
        self.attention_weights = nn.ModuleList(
            [Dense(e, h * L * p) for p in cfg.num_points])
        self.value_proj = Dense(e, e, cfg.dtype)
        self.register_buffer("normalizer", torch.tensor(
            [[w, h] for h, w in cfg.feat_shapes], dtype=torch.float32),
            persistent=False)

    @torch.no_grad()
    def init_sampling(self) -> None:
        """Upstream's init: zero kernels; each head's direction scaled by
        1..points-per-anchor as the offsets' bias; zero logits."""
        cfg = self.cfg
        h, L = cfg.num_heads, cfg.num_levels
        for off, att, a, p in zip(self.sampling_offsets,
                                  self.attention_weights,
                                  cfg.num_points_in_pillar, cfg.num_points):
            # laid out (heads, levels, anchors, points per anchor, 2)
            off.weight.zero_()
            off.bias.copy_(_offset_grid_init_2d(h, L * a, p // a))
            att.weight.zero_()
            att.bias.zero_()

    def sub_queries(self, queries: Sequence[torch.Tensor]):
        """Offsets (B, S, heads, L, P0, 2) over (W_l, H_l) and weights
        (B, S, heads, L, P0) of every sub-query slot, the planes in turn,
        each query's ``groups`` slots together; the weights are softmaxed
        over all a query's points of a head before the cut."""
        cfg = self.cfg
        heads, L, p0 = cfg.num_heads, cfg.num_levels, cfg.num_points[0]
        norm = self.normalizer
        offs, atts = [], []
        for q, fc, at, g in zip(queries, self.sampling_offsets,
                                self.attention_weights, cfg.groups):
            bsz, n, _ = q.shape
            off = fc(q.float()).reshape(bsz, n, heads, L, g, p0, 2)
            off = off / norm[:, None, None, :]
            offs.append(off.permute(0, 1, 4, 2, 3, 5, 6).reshape(
                bsz, n * g, heads, L, p0, 2))
            att = at(q.float()).reshape(bsz, n, heads, -1).softmax(-1)
            atts.append(att.reshape(bsz, n, heads, L, g, p0).permute(
                0, 1, 4, 2, 3, 5).reshape(bsz, n * g, heads, L, p0))
        return torch.cat(offs, 1), torch.cat(atts, 1)


class TPVImageCrossAttention(nn.Module):
    """Upstream's ``TPVImageCrossAttention``: the lift from the cameras
    through :class:`TPVMSDeformableAttention3D`, each query's sub-queries
    summed, the camera sum over the cameras that see the query divided by
    their count, one output projection, dropout and the residual."""

    def __init__(self, cfg: TPVConfig):
        super().__init__()
        self.cfg = cfg
        self.deformable_attention = TPVMSDeformableAttention3D(cfg)
        self.output_proj = Dense(cfg.embed_dims, cfg.embed_dims, cfg.dtype)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                lift: "Lift") -> torch.Tensor:
        """query (B, N, C); value (B, cams, nv, C); ``lift`` the frame's
        slots (:meth:`TPVFormerEncoder.lift`)."""
        cfg = self.cfg
        da = self.deformable_attention
        bsz, n, e = query.shape
        cams, nv = value.shape[1], value.shape[2]
        heads, L, p0 = cfg.num_heads, cfg.num_levels, cfg.num_points[0]
        a0 = cfg.num_points_in_pillar[0]
        v = da.value_proj(value).reshape(bsz * cams, nv, heads, e // heads)
        off, att = da.sub_queries(query.split(cfg.plane_lens, 1))
        S = off.shape[1]
        off = off.reshape(bsz, 1, S, heads, L, p0 // a0, a0, 2)
        att = att[:, None]
        if lift.idx is None:                   # the dense lift: every slot
            k = S
            off = off.expand(bsz, cams, *off.shape[2:])
            att = att.expand(bsz, cams, *att.shape[2:])
        else:
            idx = lift.idx                             # (B, cams, K)
            k = idx.shape[-1]

            def take(x):
                flat = x.reshape(bsz, 1, S, -1).expand(bsz, cams, S, -1)
                return torch.gather(flat, 2, idx[..., None].expand(
                    -1, -1, -1, flat.shape[-1]))

            off = take(off).reshape(bsz, cams, k, heads, L, p0 // a0, a0, 2)
            att = take(att)
        loc = lift.ref[:, :, :, None, None, None, :, :] + off
        out = ms_deform_attn_2d_fused(
            v.float().contiguous(), cfg.feat_shapes,
            loc.reshape(bsz * cams, k, heads, L, p0, 2).contiguous(),
            att.reshape(bsz * cams, k, heads, L, p0).contiguous())
        out = out.reshape(bsz, cams, k, e).float() * lift.valid[..., None]
        if lift.idx is not None:
            # back to each camera's own slot rows (the K indices of a camera
            # are distinct), then the camera sum in fp32
            full = torch.zeros((bsz, cams, S, e), dtype=torch.float32,
                               device=out.device)
            out = full.scatter(2, lift.idx[..., None].expand_as(out), out)
        slots = out.sum(1)                                   # (B, S, C)
        per_query, start = [], 0
        for n_p, g in zip(cfg.plane_lens, cfg.groups):
            part = slots[:, start:start + n_p * g]
            per_query.append(part.reshape(bsz, n_p, g, e).sum(2))
            start += n_p * g
        summed = torch.cat(per_query, 1)
        summed = summed / lift.count[..., None]
        return self.dropout(self.output_proj(summed.to(cfg.dtype))) + query


@dataclasses.dataclass
class Lift:
    """A frame's image cross-attention slots, shared by every layer: the
    reference points of the slots each camera runs, ``ref``
    (B, cams, K, A0, 2); which of them hold a visible query, ``valid``
    (B, cams, K) fp32; their indices among the S sub-query slots,
    ``idx`` (B, cams, K) (None for the dense lift, K = S); and each
    query's camera count, ``count`` (B, N) clamped at 1."""
    ref: torch.Tensor
    valid: torch.Tensor
    idx: torch.Tensor
    count: torch.Tensor


class TPVFormerLayer(nn.Module):
    """(hybrid attention, norm, [image cross-attention, norm,] FFN,
    norm)."""

    def __init__(self, cfg: TPVConfig, cross: bool):
        super().__init__()
        attn = [TPVCrossViewHybridAttention(cfg)]
        if cross:
            attn.append(TPVImageCrossAttention(cfg))
        self.attentions = nn.ModuleList(attn)
        self.norms = nn.ModuleList([
            LayerNorm(cfg.embed_dims, cfg.dtype, cfg.layer_norm_eps)
            for _ in range(len(attn) + 1)])
        self.ffns = nn.ModuleList([FFN(cfg.embed_dims, cfg.ffn_dim,
                                       cfg.dtype, cfg.dropout_rate)])

    def forward(self, query, pos, hybrid_ref, value, lift):
        with span("tpv#hybrid"):
            query = self.norms[0](self.attentions[0](query, pos,
                                                      hybrid_ref))
        if len(self.attentions) > 1:
            with span("tpv#ica"):
                query = self.norms[1](self.attentions[1](query, value,
                                                          lift))
        return self.norms[-1](self.ffns[0](query))


class TPVFormerEncoder(nn.Module):
    """The layers, the pillars' projection into the cameras and the
    frame's lift slots.  With a capacity K (``ica_query_capacity``, below
    the sub-query slots) ``last_overflow`` is, after each call, the visible
    slots beyond K in the worst (sample, camera), clamped at 0, an int64
    scalar on the device: nonzero means the sparse lift dropped queries.
    The dense lift drops nothing: 0."""

    def __init__(self, cfg: TPVConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList([
            TPVFormerLayer(cfg, i < cfg.cross_layers)
            for i in range(cfg.encoder_layers)])
        self.last_overflow = 0
        self._static = {}

    def static(self, device):
        """The pillars, the hybrid attention's reference points, the
        scene's range and the image plane, built on the device once (no
        host-to-device copy in a frame)."""
        if device not in self._static:
            cfg = self.cfg
            with torch.inference_mode(False):
                self._static[device] = (
                    pillar_points(cfg, device),
                    cross_view_ref_points(cfg, device),
                    torch.tensor(cfg.pc_range, dtype=torch.float32,
                                 device=device),
                    torch.tensor(cfg.image_wh, dtype=torch.float32,
                                 device=device))
        return self._static[device]

    def lift(self, world2pixel: torch.Tensor) -> Lift:
        """Project every plane's pillars into every camera; a query is
        visible in a camera where any anchor of its pillar is; its
        sub-query slots (groups of the first plane's anchor count) inherit
        that."""
        cfg = self.cfg
        dev = world2pixel.device
        bsz, cams = world2pixel.shape[:2]
        a0 = cfg.num_points_in_pillar[0]
        pillars, _, pc_range, image_wh = self.static(dev)
        refs, vis_q, vis_s = [], [], []
        shift = torch.zeros((bsz, 3), dtype=torch.float32, device=dev)
        for pts, g in zip(pillars, cfg.groups):
            n, a = pts.shape[:2]
            xy, mask = geometry.project_reference_points(
                pts.reshape(-1, 3), world2pixel, shift, pc_range=pc_range,
                image_wh=image_wh)
            refs.append(xy.reshape(bsz, cams, n * g, a0, 2))
            vis = mask.reshape(bsz, cams, n, a).any(-1)
            vis_q.append(vis)
            vis_s.append(vis.repeat_interleave(g, dim=2))
        ref = torch.cat(refs, 2)                    # (B, cams, S, a0, 2)
        visible = torch.cat(vis_s, 2)               # (B, cams, S)
        count = torch.cat(vis_q, 2).float().sum(1).clamp_min(1.0)
        cap = cfg.ica_query_capacity
        self.last_overflow = 0
        if cap and cap < visible.shape[-1]:
            self.last_overflow = lift_overflow(visible[..., None], cap)
            idx, valid = lift_slots(visible, cap)
            ref = torch.gather(ref, 2, idx[..., None, None].expand(
                -1, -1, -1, a0, 2))
            return Lift(ref, valid.float(), idx, count)
        return Lift(ref, visible.float(), None, count)

    def forward(self, query, pos, value, world2pixel):
        hybrid_ref = self.static(query.device)[1]
        lift = self.lift(world2pixel)
        for layer in self.layers:
            query = layer(query, pos, hybrid_ref, value, lift)
        return query


class TPVFormerHead(nn.Module):
    """Upstream's ``TPVFormerHead``: the planes' learned queries, the
    positional tables, the camera and level embeddings and the
    encoder."""

    def __init__(self, cfg: TPVConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dims
        self.positional_encoding = TPVPositionalEncoding(cfg)
        self.encoder = TPVFormerEncoder(cfg)
        self.level_embeds = nn.Parameter(torch.empty(cfg.num_levels, e))
        self.cams_embeds = nn.Parameter(torch.empty(cfg.num_cams, e))
        self.tpv_embedding_hw = Embedding(cfg.tpv_h * cfg.tpv_w, e)
        self.tpv_embedding_zh = Embedding(cfg.tpv_z * cfg.tpv_h, e)
        self.tpv_embedding_wz = Embedding(cfg.tpv_w * cfg.tpv_z, e)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.level_embeds.normal_(generator=generator)
        self.cams_embeds.normal_(generator=generator)

    def prep_value(self, features) -> torch.Tensor:
        """(B, cams, sum(h*w), C): each level plus its camera's embedding
        and the level's embedding, the levels concatenated (as
        ``bev2d.PerceptionTransformer2D._prep_value`` with FPN inputs)."""
        cfg = self.cfg
        if len(features) != cfg.num_levels:
            raise ValueError(f"{len(features)} feature levels, num_levels "
                             f"is {cfg.num_levels}")
        vals = []
        for lvl, feat in enumerate(features):
            b, cams, h, w = feat.shape[:4]
            val = feat.reshape(b, cams, h * w, -1).to(cfg.dtype)
            val = val + self.cams_embeds[None, :, None, :].to(cfg.dtype)
            vals.append(val + self.level_embeds[None, None, None, lvl].to(
                cfg.dtype))
        return torch.cat(vals, dim=2)

    def forward(self, features, world2pixel) -> torch.Tensor:
        """(B, hw + zh + wz, C), the encoder's output planes
        concatenated."""
        cfg = self.cfg
        bsz = features[0].shape[0]
        query = torch.cat([self.tpv_embedding_hw.weight,
                           self.tpv_embedding_zh.weight,
                           self.tpv_embedding_wz.weight], 0)
        query = query[None].expand(bsz, -1, -1).to(cfg.dtype)
        pos = self.positional_encoding().to(cfg.dtype)
        return self.encoder(query, pos, self.prep_value(features),
                            world2pixel)


class TPVAggregator(nn.Module):
    """Upstream's ``TPVAggregator`` without points: upsample each plane,
    sum the three at every lattice cell, Linear, Softplus, Linear, the
    classifier."""

    def __init__(self, cfg: TPVConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dims
        self.decoder = nn.Sequential(Dense(e, cfg.hidden_dims, cfg.dtype),
                                     nn.Softplus(),
                                     Dense(cfg.hidden_dims, e, cfg.dtype))
        self.classifier = Dense(e, cfg.num_classes, cfg.dtype)

    def forward(self, hw, zh, wz) -> torch.Tensor:
        """(B, n_plane, C) each -> logits (B, classes, W', H', Z')."""
        cfg = self.cfg
        bsz, _, c = hw.shape
        H, W, Z = cfg.tpv_h, cfg.tpv_w, cfg.tpv_z
        W2, H2, Z2 = cfg.lattice
        hw = F.interpolate(hw.transpose(1, 2).reshape(bsz, c, H, W),
                           size=(H2, W2), mode="bilinear")
        zh = F.interpolate(zh.transpose(1, 2).reshape(bsz, c, Z, H),
                           size=(Z2, H2), mode="bilinear")
        wz = F.interpolate(wz.transpose(1, 2).reshape(bsz, c, W, Z),
                           size=(W2, Z2), mode="bilinear")
        # channels last over the (W, H, Z) lattice: one lattice-sized sum
        fused = (hw.permute(0, 3, 2, 1)[:, :, :, None]
                 + zh.permute(0, 3, 2, 1)[:, None])
        fused += wz.permute(0, 2, 3, 1)[:, :, None]
        logits = self.classifier(self.decoder(fused))
        return logits.permute(0, 4, 1, 2, 3)


class TPVFormer(nn.Module):
    """TPVFormer from the neck's levels: ``tpv_head`` and
    ``tpv_aggregator`` under upstream's names."""

    def __init__(self, cfg: TPVConfig):
        super().__init__()
        self.cfg = cfg
        self.tpv_head = TPVFormerHead(cfg)
        self.tpv_aggregator = TPVAggregator(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TPVFormer":
        """Every parameter from ``generator``: lecun-normal kernels, zero
        biases, normal(1.0) query tables and embeddings, U[0, 1)
        positional tables, the samplings' zero kernels and directional
        biases; LayerNorms keep ones and zeros."""
        for m in self.modules():
            if isinstance(m, (Dense, Embedding, TPVFormerHead)):
                m.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, (TPVCrossViewHybridAttention,
                              TPVMSDeformableAttention3D)):
                m.init_sampling()
        return self

    @span("tpv#frame")
    def forward(self, features: Sequence[torch.Tensor],
                world2pixel: torch.Tensor) -> dict:
        """features: one (B, cams, h, w, C) map a level; world2pixel
        (B, cams, 4, 4) lidar-to-image.  Returns ``tpv_hw`` (B, h*w, C),
        ``tpv_zh`` (B, z*h, C), ``tpv_wz`` (B, w*z, C), ``logits``
        (B, classes, W', H', Z') and ``ica_overflow``
        (``TPVFormerEncoder.last_overflow``)."""
        cfg = self.cfg
        count("tpv#frames", features[0].shape[0])
        with span("tpv#encoder"):
            planes = self.tpv_head(features, world2pixel)
        hw, zh, wz = planes.split(cfg.plane_lens, 1)
        with span("tpv#aggregate"):
            logits = self.tpv_aggregator(hw, zh, wz)
        return {"tpv_hw": hw, "tpv_zh": zh, "tpv_wz": wz, "logits": logits,
                "ica_overflow": self.tpv_head.encoder.last_overflow}


def build_tpvformer(cfg: TPVConfig, device, seed: int = 0) -> TPVFormer:
    """A TPVFormer with random weights from ``seed``, drawn on the CPU and
    then moved to ``device``, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    return TPVFormer(cfg).init_weights(gen).to(device).eval()
