"""Voxel encoder: lifts multi-view 2D features into the 3D voxel-query grid
(PyTorch port of ``vln_ver_tpu/models/encoder.py``).

The active reference op order is ``('cross_attn', 'norm', 'ffn', 'norm')``
(vocc.py:136); with ``use_temporal_self_attn`` it is ``('self_attn',
'norm', 'cross_attn', 'norm', 'ffn', 'norm')``.  Module names follow the
reference ``state_dict`` (mmcv ``MyCustomBaseTransformerLayer``), which
numbers the attentions and norms in that order: ``attentions.0`` the SCA
and ``norms.{0,1}`` without TSA; ``attentions.0`` the TSA,
``attentions.1`` the SCA and ``norms.{0,1,2}`` with it;
``ffns.0.layers.{0.0,1}`` in both.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import geometry
from .attention import SpatialCrossAttention
from .config import VERConfig
from .layers import Dense, Dropout, LayerNorm
from .temporal import VoxelTemporalSelfAttention


class FFN(nn.Module):
    """mmcv FFN: Linear -> ReLU -> Dropout -> Linear -> Dropout, residual
    add (vln_ver_tpu/models/encoder.py:29-45); the dropouts are the
    identity in ``eval()``."""

    def __init__(self, embed_dims: int, feedforward_dim: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Dense(embed_dims, feedforward_dim, dtype),
                          nn.ReLU(), Dropout(dropout_rate)),
            Dense(feedforward_dim, embed_dims, dtype),
            Dropout(dropout_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x) + x


class VoxelEncoderLayer(nn.Module):
    """cross_attn -> norm -> ffn -> norm (VoxelFormerLayer active order),
    with a TSA block and its norm ahead of it under
    ``use_temporal_self_attn``."""

    def __init__(self, cfg: VERConfig):
        super().__init__()
        self.temporal = cfg.use_temporal_self_attn
        attentions = []
        if self.temporal:
            attentions.append(VoxelTemporalSelfAttention(
                cfg.embed_dims, cfg.num_heads, cfg.num_levels,
                cfg.tsa_num_points, cfg.num_bev_queue, cfg.dtype,
                cfg.dropout_rate))
        attentions.append(SpatialCrossAttention(
            cfg.embed_dims, cfg.num_heads, cfg.num_levels,
            cfg.sca_num_points, cfg.dtype, cfg.sca_query_capacity,
            cfg.dropout_rate))
        self.attentions = nn.ModuleList(attentions)
        self.norms = nn.ModuleList([LayerNorm(cfg.embed_dims, cfg.dtype)
                                    for _ in range(len(attentions) + 1)])
        self.ffns = nn.ModuleList([FFN(cfg.embed_dims, cfg.ffn_dim,
                                       cfg.dtype, cfg.dropout_rate)])
        self.grid = ((cfg.bev_z, cfg.bev_h, cfg.bev_w),)

    def forward(self, query, value, reference_points_cam, bev_mask,
                spatial_shapes: Sequence[Tuple[int, int]], prev_bev=None,
                ref_2d=None, bev_pos=None, frame_query=None, shift=None):
        if self.temporal:
            query = self.norms[0](self.attentions[0](
                query, prev_bev, ref_2d, self.grid, query_pos=bev_pos,
                frame_query=frame_query, shift=shift))
        query = self.attentions[-1](query, value, reference_points_cam,
                                    bev_mask, spatial_shapes)
        query = self.norms[-2](query)
        query = self.ffns[0](query)
        return self.norms[-1](query)


class VoxelEncoder(nn.Module):
    """Stack of ``encoder_layers`` VoxelEncoderLayers.  With
    ``remat_encoder`` each layer runs under ``torch.utils.checkpoint`` when
    gradients are on: its activations are recomputed in the backward
    instead of kept (vln_ver_tpu/models/encoder.py:115-118).  The replay
    restores the default generators, so it redraws the same dropout
    masks.

    With ``use_temporal_self_attn`` the TSA's reference points are the
    normalised voxel centres and its current value slot is the
    frame-initial grid, stacked once before the layer loop
    (voxel_encoder.py:261-263)."""

    def __init__(self, cfg: VERConfig):
        super().__init__()
        self.cfg = cfg
        self.remat = cfg.remat_encoder
        self.layers = nn.ModuleList([VoxelEncoderLayer(cfg)
                                     for _ in range(cfg.encoder_layers)])

    def forward(self, bev_query, value, reference_points_cam, bev_mask,
                spatial_shapes: Sequence[Tuple[int, int]], prev_bev=None,
                bev_pos=None, shift=None):
        cfg = self.cfg
        ref_2d = frame_query = None
        if cfg.use_temporal_self_attn:
            ref_2d = geometry.voxel_reference_points(
                cfg.bev_z, cfg.bev_h, cfg.bev_w, device=bev_query.device)
            ref_2d = ref_2d[None, :, None, :].expand(
                bev_query.shape[0], -1, -1, -1)
            frame_query = bev_query
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            args = (bev_query, value, reference_points_cam, bev_mask,
                    spatial_shapes, prev_bev, ref_2d, bev_pos, frame_query,
                    shift)
            bev_query = (checkpoint(layer, *args, use_reentrant=False)
                         if remat else layer(*args))
        return bev_query
