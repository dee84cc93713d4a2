"""BEVFormer-2D model family: the reference's 2D-BEV lineage (PyTorch port
of ``vln_ver_tpu/models/bev2d.py``).

The reference carries the original BEVFormer 2D stack beside the voxel
(VER) variants: ``PerceptionTransformer`` (modules/transformer.py:26-303,
can-bus conditioning and prev-BEV ego-motion alignment) and
``TemporalSelfAttention`` (modules/temporal_self_attention.py:25-271,
2-slot BEV queue); its ``BEVFormerEncoder`` / ``BEVFormerLayer`` and
``DetectionTransformerDecoder`` / ``CustomMSDeformableAttention`` shipped
only as .pyc and are reconstructed from their call sites and their voxel
liftings, as the JAX package does.

All three deformable samplings are 2D and go through
``ops.deform_cuda.ms_deform_attn_2d_fused``: the camera lift (the port's
``SpatialCrossAttention``, 4 pillar anchors sharing the 8 points, over
``num_levels`` feature levels), the 2D temporal self-attention over the
(prev, current) BEV queue, and the decoder's cross-attention over the BEV
grid (one level each, as upstream).  On the CPU that is the plain
version; on the card, a hand-written kernel: the staged one for one level
that fits in shared memory, else the gather kernel, which has no
backward, so that a card forward that needs a gradient there raises.

At upstream BEVFormer's settings (``use_shift``, ``use_can_bus``,
``fpn_inputs``, several ``feat_shapes``) the model is BEVFormer-base
without its image backbone and neck: :meth:`BEVFormer2D.forward_test` is
upstream's video inference entry (``BEVFormer.forward_test``), which
carries ``prev_bev`` and the ego pose from frame to frame in a
:class:`VideoState`.

Module names follow the reference's mmcv layers: ``attentions.{0,1}``,
``norms.{0,1,2}``, ``ffns.0`` in every encoder and decoder layer.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import geometry
from ..ops.deform_cuda import GATHER_ROUTE, ms_deform_attn_2d_fused, route
from ..ops.sampling import bilinear_sample_2d
from ..utils.profiling import count, span
from .attention import (CamDeformableAttention, MultiheadAttention,
                        SpatialCrossAttention, _offset_grid_init_2d,
                        _PackedAttention, lift_overflow)
from .decoder import inverse_sigmoid
from .encoder import FFN
from .head import ClsBranch, Embedding, _UniformTable
from .layers import Dense, Dropout, LayerNorm
from .temporal import fold_queue, queue_offsets_init
from .transformer import RegBranch


@dataclasses.dataclass(frozen=True)
class BEV2DConfig:
    bev_h: int = 15
    bev_w: int = 15
    embed_dims: int = 256
    num_heads: int = 8
    encoder_layers: int = 3
    decoder_layers: int = 6
    ffn_dim: int = 512
    num_query: int = 100
    num_points_in_pillar: int = 4
    sca_num_points: int = 8
    tsa_num_points: int = 4
    decoder_num_points: int = 4
    num_levels: int = 1
    num_cams: int = 6
    feat_h: int = 14
    feat_w: int = 14
    in_channels: int = 768
    canbus_dims: int = 18
    pc_range: Tuple[float, ...] = geometry.PC_RANGE
    # the camera features' levels, (h, w) each, finest first; empty: one
    # level of feat_h x feat_w.  The lift samples them all; the TSA and the
    # decoder sample the one BEV map
    feat_shapes: Tuple[Tuple[int, int], ...] = ()
    # features that arrive at embed_dims from an FPN, as upstream's neck
    # gives them: no input_proj
    fpn_inputs: bool = False
    # the sparse lift's query slots a camera (SpatialCrossAttention's
    # query_capacity); 0: the dense lift
    sca_query_capacity: int = 0
    # the image plane that normalises pixel coordinates (upstream: the
    # padded img_shape, (w, h))
    image_wh: Tuple[float, float] = geometry.IMAGE_WH
    # the reference as shipped: its 2D transformer zeroes the ego shift
    # (transformer.py:148) and comments out the can-bus query add
    # (:165-169); only prev-BEV rotation is live.  Upstream BEVFormer
    # enables all three.
    use_shift: bool = False
    use_can_bus: bool = False
    can_bus_norm: bool = True
    rotate_prev_bev: bool = True
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.feat_shapes and len(self.feat_shapes) != self.num_levels:
            raise ValueError(f"feat_shapes {self.feat_shapes} name "
                             f"{len(self.feat_shapes)} levels, num_levels "
                             f"is {self.num_levels}")
        if self.fpn_inputs and self.in_channels != self.embed_dims:
            raise ValueError(f"fpn_inputs: in_channels {self.in_channels} "
                             f"must be embed_dims {self.embed_dims}")

    @property
    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """(h, w) of each camera feature level."""
        return (tuple(tuple(s) for s in self.feat_shapes)
                or ((self.feat_h, self.feat_w),) * self.num_levels)

    @property
    def bev_num(self) -> int:
        return self.bev_h * self.bev_w

    @property
    def grid_length(self) -> Tuple[float, float]:
        """(grid_length_y, grid_length_x) in metres per BEV cell."""
        pc = self.pc_range
        return ((pc[4] - pc[1]) / self.bev_h, (pc[3] - pc[0]) / self.bev_w)


class LearnedPositionalEncoding2D(nn.Module):
    """mmcv ``LearnedPositionalEncoding``: learned row and column
    embeddings of ``embed_dims // 2`` features each, concatenated
    [col(x), row(y)] per cell; the TSA's query_pos."""

    def __init__(self, embed_dims: int, bev_h: int, bev_w: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.row_embed = _UniformTable(bev_h, embed_dims // 2)
        self.col_embed = _UniformTable(bev_w, embed_dims // 2)
        self.dtype = dtype

    def forward(self, batch_size: int) -> torch.Tensor:
        """(batch, bev_h*bev_w, C), h-major."""
        row, col = self.row_embed.weight, self.col_embed.weight
        h, w, nf = row.shape[0], col.shape[0], row.shape[1]
        pos = torch.cat([col[None, :, :].expand(h, w, nf),
                         row[:, None, :].expand(h, w, nf)], dim=-1)
        return pos.reshape(1, h * w, 2 * nf).to(self.dtype).expand(
            batch_size, -1, -1)


def rotate_bev(bev: torch.Tensor, angle_deg: torch.Tensor, bev_h: int,
               bev_w: int) -> torch.Tensor:
    """Rotate BEV grids about their centre (bilinear, zero fill).

    ``bev (B, h*w, C)``, ``angle_deg (B,)`` counter-clockwise degrees: the
    reference's per-sample ``torchvision ... rotate(tmp_prev_bev,
    rotation_angle)`` (transformer.py:154-164) as one resample through
    ``ops.sampling.bilinear_sample_2d``."""
    b, _, c = bev.shape
    grid = bev.reshape(b, bev_h, bev_w, c).float()
    rad = torch.deg2rad(angle_deg.float())
    cos, sin = rad.cos()[:, None, None], rad.sin()[:, None, None]
    cy, cx = (bev_h - 1) / 2.0, (bev_w - 1) / 2.0
    ys = torch.arange(bev_h, dtype=torch.float32, device=bev.device) - cy
    xs = torch.arange(bev_w, dtype=torch.float32, device=bev.device) - cx
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    # the inverse rotation of the output coordinates gives the source's; a
    # positive angle turns the content counter-clockwise on screen (y-down
    # display coordinates), torchvision rotate's convention
    src_x = cos * xg - sin * yg + cx
    src_y = sin * xg + cos * yg + cy
    out = bilinear_sample_2d(grid, src_x.reshape(b, -1),
                             src_y.reshape(b, -1))
    return out.reshape(b, bev_h * bev_w, c).to(bev.dtype)


def ego_motion_shift(can_bus: torch.Tensor, cfg: BEV2DConfig
                     ) -> torch.Tensor:
    """Normalised (x, y) BEV shift (B, 2) from the can-bus ego motion (the
    BEVFormer recipe, present and commented at transformer.py:127-147):
    translation length and angle from ``can_bus[:, 0:2]``, ego yaw from
    ``can_bus[:, -2]`` (radians), the shift in grid fractions."""
    delta = can_bus[:, 0:2].float()
    length = delta.square().sum(dim=1).sqrt()
    translation_angle = torch.atan2(delta[:, 1], delta[:, 0])
    bev_angle = can_bus[:, -2].float() - translation_angle
    gy, gx = cfg.grid_length
    shift_y = length * bev_angle.cos() / gy / cfg.bev_h
    shift_x = length * bev_angle.sin() / gx / cfg.bev_w
    return torch.stack([shift_x, shift_y], dim=1)


class _Deformable2D(nn.Module):
    """The parameters of a 2D deformable attention with output projection
    (reference names), offsets and weights predicted from ``query_dims``
    features for ``slots`` value slots."""

    def __init__(self, embed_dims: int, num_heads: int, num_levels: int,
                 num_points: int, query_dims: int, slots: int,
                 dtype: torch.dtype, dropout_rate: float):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.slots = slots
        self.dtype = dtype
        n_off = slots * num_heads * num_levels * num_points
        self.value_proj = Dense(embed_dims, embed_dims, dtype)
        self.sampling_offsets = Dense(query_dims, n_off * 2)
        self.attention_weights = Dense(query_dims, n_off)
        self.output_proj = Dense(embed_dims, embed_dims, dtype)
        self.dropout = Dropout(dropout_rate)

    @torch.no_grad()
    def init_sampling(self) -> None:
        """flax init: zero kernels, the 2D directional grid as the offsets'
        bias (per slot within each head), zero attention weights."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(queue_offsets_init(
            _offset_grid_init_2d(self.num_heads, self.num_levels,
                                 self.num_points), self.num_heads,
            self.slots))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()


class TemporalSelfAttention2D(_Deformable2D):
    """2-slot 2D deformable temporal self-attention (reference
    temporal_self_attention.py:25-271): offsets and weights from the
    [previous, current] concatenation, the queue folded into the batch
    (row ``b * 2 + slot``), the two slots' outputs averaged.  Without
    ``prev_bev`` both value slots are the layer's query (":96-100")."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 num_bev_queue: int = 2, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1):
        if num_bev_queue != 2:
            raise ValueError(f"num_bev_queue={num_bev_queue}: the TSA "
                             "queue has two slots (previous, current)")
        super().__init__(embed_dims, num_heads, num_levels, num_points,
                         2 * embed_dims, num_bev_queue, dtype, dropout_rate)

    def forward(self, query: torch.Tensor, prev_bev: Optional[torch.Tensor],
                ref_current: torch.Tensor, ref_prev: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                query_pos: Optional[torch.Tensor] = None,
                frame_query: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, nq, C); ref_* (B, nq, L, 2) normalised BEV
        coordinates, ``ref_prev`` shifted by the ego motion for the
        history slot.  As in the voxel TSA, the values carry no
        ``query_pos``; with ``prev_bev`` the current slot is
        ``frame_query`` (the frame-initial grid) and slot 0 samples at
        ``ref_prev``; without it both slots are the pos-less query at
        ``ref_current``."""
        bsz, nq, c = query.shape
        heads, levels, points = (self.num_heads, self.num_levels,
                                 self.num_points)
        queue = self.slots
        identity = raw = query
        if query_pos is not None:
            query = query + query_pos
        if prev_bev is not None:
            prev = prev_bev
            cur = frame_query if frame_query is not None else raw
            ref0 = ref_prev
        else:
            prev = cur = raw
            ref0 = ref_current
        value = self.value_proj(fold_queue(prev, cur)).reshape(
            bsz * queue, nq, heads, c // heads)
        q_cat = torch.cat([prev, query], dim=-1).float()

        offsets = self.sampling_offsets(q_cat).reshape(
            bsz, nq, heads, queue, levels, points, 2)
        attn = self.attention_weights(q_cat).reshape(
            bsz, nq, heads, queue, levels * points).softmax(dim=-1)
        attn = attn.reshape(bsz, nq, heads, queue, levels, points).permute(
            0, 3, 1, 2, 4, 5).reshape(bsz * queue, nq, heads, levels, points)
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(
            bsz * queue, nq, heads, levels, points, 2)
        normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        ref = fold_queue(ref0, ref_current).float()
        locations = (ref[:, :, None, :, None, :]
                     + offsets / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn_2d_fused(value.float().contiguous(),
                                      spatial_shapes, locations.contiguous(),
                                      attn.contiguous())
        out = out.reshape(bsz, queue, nq, self.embed_dims).mean(dim=1)
        out = self.output_proj(out.to(self.dtype))
        return self.dropout(out) + identity


class CustomMSDeformableAttention2D(_Deformable2D):
    """The decoder's ``CustomMSDeformableAttention``: 2D deformable-DETR
    cross-attention with output projection, dropout and residual."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__(embed_dims, num_heads, num_levels, num_points,
                         embed_dims, 1, dtype, dropout_rate)

    def forward(self, query, value, reference_points, spatial_shapes,
                query_pos=None):
        """query (B, nq, C); value (B, nv, C); reference_points
        (B, nq, L, 2) in [0, 1]."""
        bsz, nq, _ = query.shape
        heads, levels, points = (self.num_heads, self.num_levels,
                                 self.num_points)
        identity = query
        if query_pos is not None:
            query = query + query_pos
        v = self.value_proj(value).reshape(bsz, value.shape[1], heads,
                                           self.embed_dims // heads)
        offsets = self.sampling_offsets(query).reshape(
            bsz, nq, heads, levels, points, 2)
        attn = self.attention_weights(query).reshape(
            bsz, nq, heads, levels * points).softmax(dim=-1).reshape(
                bsz, nq, heads, levels, points)
        normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        locations = (reference_points[:, :, None, :, None, :].float()
                     + offsets / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn_2d_fused(v.float().contiguous(), spatial_shapes,
                                      locations.contiguous(),
                                      attn.contiguous())
        out = self.output_proj(out.to(self.dtype))
        return self.dropout(out) + identity


class BEV2DEncoderLayer(nn.Module):
    """self_attn (TSA) -> norm -> cross_attn (SCA) -> norm -> ffn ->
    norm."""

    def __init__(self, cfg: BEV2DConfig):
        super().__init__()
        self.attentions = nn.ModuleList([
            TemporalSelfAttention2D(cfg.embed_dims, cfg.num_heads, 1,
                                    cfg.tsa_num_points, 2, cfg.dtype,
                                    cfg.dropout_rate),
            SpatialCrossAttention(cfg.embed_dims, cfg.num_heads,
                                  cfg.num_levels, cfg.sca_num_points,
                                  cfg.dtype, cfg.sca_query_capacity,
                                  cfg.dropout_rate)])
        self.norms = nn.ModuleList([LayerNorm(cfg.embed_dims, cfg.dtype)
                                    for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(cfg.embed_dims, cfg.ffn_dim,
                                       cfg.dtype, cfg.dropout_rate)])
        self.bev_shape = ((cfg.bev_h, cfg.bev_w),)

    def forward(self, query, value, reference_points_cam, bev_mask,
                spatial_shapes, prev_bev, ref_current, ref_prev,
                bev_pos=None, frame_query=None):
        with span("bev#tsa"):
            query = self.norms[0](self.attentions[0](
                query, prev_bev, ref_current, ref_prev, self.bev_shape,
                query_pos=bev_pos, frame_query=frame_query))
        with span("bev#sca"):
            query = self.norms[1](self.attentions[1](
                query, value, reference_points_cam, bev_mask,
                spatial_shapes))
        return self.norms[2](self.ffns[0](query))


class BEVFormerEncoder2D(nn.Module):
    """BEVFormerEncoder (reconstructed from its voxel lifting,
    voxel_encoder.py:30-296): the pillar-sampled camera lift and the
    TSA.

    With a query capacity K (``sca_query_capacity``, below the BEV's
    queries) ``last_overflow`` is, after each call, the number of visible
    queries beyond K in the worst (sample, camera) slot, clamped at 0, an
    int64 scalar on the device: nonzero means the sparse lift dropped
    queries.  The dense lift drops nothing: 0."""

    def __init__(self, cfg: BEV2DConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList([BEV2DEncoderLayer(cfg)
                                     for _ in range(cfg.encoder_layers)])
        self.last_overflow = 0

    def forward(self, bev_query, value, world2pixel, origin_shift,
                prev_bev=None, shift=None, bev_pos=None):
        cfg = self.cfg
        bsz, dev = bev_query.shape[0], bev_query.device
        anchors = cfg.num_points_in_pillar
        pillars = geometry.pillar_reference_points(
            cfg.bev_h, cfg.bev_w, anchors,
            z_extent=cfg.pc_range[5] - cfg.pc_range[2], device=dev)
        cam_xy, mask = geometry.project_reference_points(
            pillars.reshape(-1, 3), world2pixel, origin_shift,
            pc_range=cfg.pc_range, image_wh=cfg.image_wh)
        cam_xy = cam_xy.reshape(bsz, cfg.num_cams, cfg.bev_num, anchors, 2)
        mask = mask.reshape(bsz, cfg.num_cams, cfg.bev_num, anchors)
        cap = cfg.sca_query_capacity
        self.last_overflow = 0
        if cap and cap < cfg.bev_num:
            self.last_overflow = lift_overflow(mask, cap)

        ref_current = geometry.bev_reference_points(
            cfg.bev_h, cfg.bev_w, device=dev)[None, :, None, :].expand(
                bsz, -1, 1, -1)
        if shift is None:
            shift = torch.zeros((bsz, 2), dtype=torch.float32, device=dev)
        ref_prev = ref_current + shift[:, None, None, :]
        spatial_shapes = cfg.level_shapes
        # [prev_bev, bev_query] is stacked once before the layer loop:
        # every layer's current value slot is the frame-initial grid
        frame_query = bev_query
        for layer in self.layers:
            bev_query = layer(bev_query, value, cam_xy, mask, spatial_shapes,
                              prev_bev, ref_current, ref_prev,
                              bev_pos=bev_pos, frame_query=frame_query)
        return bev_query


class DecoderLayer2D(nn.Module):
    """self_attn -> norm -> cross_attn (2D deformable) -> norm -> ffn ->
    norm."""

    def __init__(self, cfg: BEV2DConfig):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(cfg.embed_dims, cfg.num_heads,
                               cfg.dropout_rate, cfg.dtype),
            CustomMSDeformableAttention2D(
                cfg.embed_dims, cfg.num_heads, 1, cfg.decoder_num_points,
                cfg.dtype, cfg.dropout_rate)])
        self.norms = nn.ModuleList([LayerNorm(cfg.embed_dims, cfg.dtype)
                                    for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(cfg.embed_dims, cfg.ffn_dim,
                                       cfg.dtype, cfg.dropout_rate)])

    def forward(self, query, value, query_pos, reference_points,
                spatial_shapes):
        q = self.norms[0](self.attentions[0](query, query_pos=query_pos,
                                             key_pos=query_pos))
        q = self.norms[1](self.attentions[1](q, value, reference_points,
                                             spatial_shapes,
                                             query_pos=query_pos))
        return self.norms[2](self.ffns[0](q))


class DetectionTransformerDecoder2D(nn.Module):
    """The DETR decoder over the BEV grid with iterative reference
    refinement (reconstructed from its 3D lifting, voxel_decoder.py:
    53-132).  The references are 3D, but only (x, y) sample the grid; z
    rides along for the box decode."""

    def __init__(self, cfg: BEV2DConfig):
        super().__init__()
        self.bev_shape = ((cfg.bev_h, cfg.bev_w),)
        self.layers = nn.ModuleList([DecoderLayer2D(cfg)
                                     for _ in range(cfg.decoder_layers)])

    def forward(self, query, value, query_pos, reference_points,
                reg_branches: Sequence[Callable]):
        """Returns (inter_states (L, B, nq, C), refs_before (L, B, nq, 3),
        raw_preds (L, B, nq, code_size))."""
        inter_states, refs_before, raw_preds = [], [], []
        for lid, layer in enumerate(self.layers):
            refs_before.append(reference_points)
            query = layer(query, value, query_pos,
                          reference_points[:, :, None, 0:2], self.bev_shape)
            tmp = reg_branches[lid](query)
            raw_preds.append(tmp)
            new_xy = tmp[..., 0:2] + inverse_sigmoid(
                reference_points[..., 0:2])
            new_z = tmp[..., 4:5] + inverse_sigmoid(
                reference_points[..., 2:3])
            reference_points = torch.cat([new_xy, new_z], -1).sigmoid() \
                .detach()
            inter_states.append(query)
        return (torch.stack(inter_states), torch.stack(refs_before),
                torch.stack(raw_preds))


class PerceptionTransformer2D(nn.Module):
    """The 2D ``PerceptionTransformer`` (transformer.py:26-303): can-bus
    conditioning, prev-BEV ego-motion alignment (shift and rotation),
    camera and level embeddings, the encoder lift and the 2D decoder."""

    def __init__(self, cfg: BEV2DConfig):
        super().__init__()
        self.cfg = cfg
        e, dt = cfg.embed_dims, cfg.dtype
        self.level_embeds = nn.Parameter(torch.empty(cfg.num_levels, e))
        self.cams_embeds = nn.Parameter(torch.empty(cfg.num_cams, e))
        # upstream takes the FPN's maps at embed_dims as they are
        self.input_proj = (None if cfg.fpn_inputs
                           else Dense(cfg.in_channels, e, dt))
        if cfg.use_can_bus:
            # reference can_bus_mlp (transformer.py:77-85), its LayerNorm
            # under can_bus_norm named as upstream BEVFormer's; built only
            # where it is used, as flax creates it
            mlp = [("0", Dense(cfg.canbus_dims, e // 2, dt)),
                   ("1", nn.ReLU()), ("2", Dense(e // 2, e, dt)),
                   ("3", nn.ReLU())]
            if cfg.can_bus_norm:
                mlp.append(("norm", LayerNorm(e, dt)))
            self.can_bus_mlp = nn.Sequential(collections.OrderedDict(mlp))
        self.encoder = BEVFormerEncoder2D(cfg)
        self.decoder = DetectionTransformerDecoder2D(cfg)
        self.reference_points = Dense(e, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.level_embeds.normal_(generator=generator)
        self.cams_embeds.normal_(generator=generator)

    def _prep_value(self, features):
        """(B, cam, sum(h*w), C): each level projected (without
        ``fpn_inputs``), plus the camera embedding and its level's
        embedding, the levels concatenated (upstream
        ``PerceptionTransformer.get_bev_features``)."""
        cfg = self.cfg
        levels = (features if isinstance(features, (list, tuple))
                  else (features,))
        if len(levels) != cfg.num_levels:
            raise ValueError(f"{len(levels)} feature levels, num_levels is "
                             f"{cfg.num_levels}")
        vals = []
        for lvl, feat in enumerate(levels):
            b, cams, h, w = feat.shape[:4]
            val = feat.reshape(b, cams, h * w, -1)
            val = (val.to(cfg.dtype) if self.input_proj is None
                   else self.input_proj(val))
            val = val + self.cams_embeds[None, :, None, :].to(cfg.dtype)
            vals.append(val + self.level_embeds[None, None, None, lvl].to(
                cfg.dtype))
        return vals[0] if len(vals) == 1 else torch.cat(vals, dim=2)

    def get_bev_features(self, bev_queries, features, world2pixel,
                         origin_shift, can_bus=None, prev_bev=None,
                         bev_pos=None):
        """bev_queries (B, h*w, C); features (B, cam, fh, fw, Cin), or a
        sequence of one such tensor a level; can_bus (B, 18) or None;
        prev_bev (B, h*w, C) or None."""
        cfg = self.cfg
        with span("bev#align"):
            shift = torch.zeros((bev_queries.shape[0], 2),
                                dtype=torch.float32,
                                device=bev_queries.device)
            if can_bus is not None:
                if cfg.use_shift:
                    shift = ego_motion_shift(can_bus, cfg)
                if prev_bev is not None and cfg.rotate_prev_bev:
                    prev_bev = rotate_bev(prev_bev, can_bus[:, -1],
                                          cfg.bev_h, cfg.bev_w)
                if cfg.use_can_bus:
                    bev_queries = bev_queries + self.can_bus_mlp(
                        can_bus.to(cfg.dtype))[:, None, :]
        with span("bev#encoder"):
            return self.encoder(bev_queries, self._prep_value(features),
                                world2pixel, origin_shift,
                                prev_bev=prev_bev, shift=shift,
                                bev_pos=bev_pos)

    def forward(self, bev_queries, features, world2pixel, origin_shift,
                object_query_embed, reg_branches, can_bus=None,
                prev_bev=None, bev_pos=None):
        """object_query_embed (num_query, 2C), split into (pos, query)
        (transformer.py:239-247).  Returns (bev_embed, inter_states,
        refs_before, raw_preds)."""
        cfg = self.cfg
        b = bev_queries.shape[0]
        bev_embed = self.get_bev_features(
            bev_queries, features, world2pixel, origin_shift,
            can_bus=can_bus, prev_bev=prev_bev, bev_pos=bev_pos)
        query_pos, query = object_query_embed.chunk(2, dim=-1)
        query_pos = query_pos[None].expand(b, -1, -1)
        query = query[None].expand(b, -1, -1)
        with span("bev#decoder"):
            ref = self.reference_points(query_pos.float()).sigmoid()
            inter_states, refs_before, raw_preds = self.decoder(
                query.to(cfg.dtype), bev_embed, query_pos.to(cfg.dtype), ref,
                reg_branches)
        return bev_embed, inter_states, refs_before, raw_preds


class BEVFormer2D(nn.Module):
    """End-to-end BEVFormer-2D: learned BEV queries and positional
    encoding, the 2D perception transformer, and per-decoder-layer class
    and regression branches with the coordinate decode (the BEVFormer
    head recipe on the 10-code box codec)."""

    def __init__(self, cfg: BEV2DConfig, num_classes: int = 10,
                 code_size: int = 10):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dims
        self.bev_embedding = Embedding(cfg.bev_num, e)
        self.query_embedding = Embedding(cfg.num_query, 2 * e)
        self.positional_encoding = LearnedPositionalEncoding2D(
            e, cfg.bev_h, cfg.bev_w, cfg.dtype)
        self.transformer = PerceptionTransformer2D(cfg)
        self.cls_branches = nn.ModuleList([
            ClsBranch(e, num_classes) for _ in range(cfg.decoder_layers)])
        self.reg_branches = nn.ModuleList([
            RegBranch(e, code_size, 2, cfg.dtype)
            for _ in range(cfg.decoder_layers)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BEVFormer2D":
        """Every parameter from ``generator`` with the flax initialisers'
        distributions (lecun-normal kernels, zero biases, normal(1.0)
        tables, U[0, 1) positional tables, the sampling offsets' zero
        kernels and directional biases, the class branches' focal prior);
        LayerNorms keep ones and zeros."""
        for m in self.modules():
            if isinstance(m, (Dense, Embedding, PerceptionTransformer2D,
                              _PackedAttention)):
                m.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, (CamDeformableAttention, _Deformable2D)):
                m.init_sampling()
            elif isinstance(m, ClsBranch):
                m.init_prior()
        return self

    def forward(self, features, world2pixel, origin_shift, can_bus=None,
                prev_bev=None, only_bev: bool = False):
        """features (B, cams, fh, fw, Cin); world2pixel (B, cams, 4, 4);
        origin_shift (B, 3); can_bus (B, 18) or None; prev_bev (B, h*w, C)
        or None.  ``only_bev`` returns the BEV grid (B, h*w, C) (the
        history extraction); else ``{"bev_embed", "all_cls_scores"
        (L, B, nq, classes), "all_bbox_preds" (L, B, nq, code)}``."""
        cfg = self.cfg
        first = features[0] if isinstance(features, (list, tuple)) \
            else features
        if first.is_cuda and torch.is_grad_enabled() and \
                self.gathered() and any(p.requires_grad
                                        for p in self.parameters()):
            raise ValueError(
                f"the samplings of {self.gathered()} take the gather kernel "
                "(ops/deform_cuda.py), which has no backward: run the "
                "card forward under torch.no_grad() or inference_mode()")
        b = first.shape[0]
        bev_queries = self.bev_embedding.weight[None].expand(
            b, -1, -1).to(cfg.dtype)
        bev_pos = self.positional_encoding(b)
        if only_bev:
            return self.transformer.get_bev_features(
                bev_queries, features, world2pixel, origin_shift,
                can_bus=can_bus, prev_bev=prev_bev, bev_pos=bev_pos)
        bev_embed, inter, refs, raw = self.transformer(
            bev_queries, features, world2pixel, origin_shift,
            self.query_embedding.weight, self.reg_branches, can_bus=can_bus,
            prev_bev=prev_bev, bev_pos=bev_pos)
        # per-layer decode: the pre-layer reference added back in
        # inverse-sigmoid space, as the VER head does (head:587-610)
        lo, hi = cfg.pc_range[:3], cfg.pc_range[3:]
        xy = (raw[..., 0:2] + inverse_sigmoid(refs[..., 0:2])).sigmoid()
        z = (raw[..., 4:5] + inverse_sigmoid(refs[..., 2:3])).sigmoid()
        bbox = torch.cat([xy[..., 0:1] * (hi[0] - lo[0]) + lo[0],
                          xy[..., 1:2] * (hi[1] - lo[1]) + lo[1],
                          raw[..., 2:4], z * (hi[2] - lo[2]) + lo[2],
                          raw[..., 5:]], dim=-1)
        cls = torch.stack([branch(inter[lid].float())
                           for lid, branch in enumerate(self.cls_branches)])
        return {"bev_embed": bev_embed, "all_cls_scores": cls,
                "all_bbox_preds": bbox}

    def gathered(self) -> Tuple[str, ...]:
        """The samplings (``lift``, ``bev``) whose shapes take the gather
        kernel on the card (``ops.deform_cuda.route``)."""
        cfg = self.cfg
        d = cfg.embed_dims // cfg.num_heads
        elt = 2 if cfg.dtype == torch.bfloat16 else 4
        # the TSA's values and the decoder's are cast to fp32
        return tuple(name for name, shapes, e in (
            ("lift", cfg.level_shapes, elt),
            ("bev", ((cfg.bev_h, cfg.bev_w),), 4))
            if route(shapes, d, e) == GATHER_ROUTE)

    @span("bev#frame")
    def forward_test(self, frame: dict, state: VideoState) -> dict:
        """One frame of video inference, upstream's
        ``BEVFormer.forward_test`` at batch 1: a frame of a new scene (its
        ``scene_token`` differs from the state's) starts without
        ``prev_bev``; the absolute can-bus's position ``[:3]`` and yaw in
        degrees ``[-1]`` become the deltas from the previous frame, 0 where
        there is no previous frame; the frame's ``bev_embed`` and pose are
        the state of the next.

        ``frame``: ``features`` (as :meth:`forward` takes them, batch 1),
        ``world2pixel`` (1, cams, 4, 4), ``origin_shift`` (1, 3),
        ``can_bus`` (18,) absolute, on the host, ``scene_token``.  Returns
        :meth:`forward`'s outputs and ``sca_overflow``
        (``BEVFormerEncoder2D.last_overflow``)."""
        if frame["scene_token"] != state.scene_token:
            state.prev_bev = None
        state.scene_token = frame["scene_token"]
        can_bus = np.array(frame["can_bus"], dtype=np.float64)
        pos, angle = can_bus[:3].copy(), float(can_bus[-1])
        count("bev#frames", 1)
        if state.prev_bev is not None:
            count("bev#prev_bev_frames", 1)
            can_bus[:3] -= state.prev_pos
            can_bus[-1] -= state.prev_angle
        else:
            can_bus[:3] = 0.0
            can_bus[-1] = 0.0
        dev = frame["world2pixel"].device
        out = self(frame["features"], frame["world2pixel"],
                   frame["origin_shift"],
                   can_bus=torch.from_numpy(can_bus.astype(
                       np.float32))[None].to(dev),
                   prev_bev=state.prev_bev)
        state.prev_bev = out["bev_embed"]
        state.prev_pos, state.prev_angle = pos, angle
        return dict(out, sca_overflow=self.transformer.encoder.last_overflow)


@dataclasses.dataclass
class VideoState:
    """What :meth:`BEVFormer2D.forward_test` carries from frame to frame
    (upstream ``BEVFormer.prev_frame_info``): the scene, the previous
    frame's ``bev_embed``, and its absolute ego position (can-bus [:3],
    metres) and yaw (can-bus [-1], degrees)."""
    scene_token: object = None
    prev_bev: Optional[torch.Tensor] = None
    prev_pos: Optional[np.ndarray] = None
    prev_angle: float = 0.0


def build_bev2d(cfg: BEV2DConfig, device, seed: int = 0) -> BEVFormer2D:
    """A BEVFormer2D with random weights from ``seed``, drawn on the CPU
    and then moved to ``device``, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    return BEVFormer2D(cfg).init_weights(gen).to(device).eval()
