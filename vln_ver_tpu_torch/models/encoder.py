"""Voxel encoder: lifts multi-view 2D features into the 3D voxel-query grid
(PyTorch port of ``vln_ver_tpu/models/encoder.py``, non-temporal path).

The active reference op order is ``('cross_attn', 'norm', 'ffn', 'norm')``
(vocc.py:136).  Module names follow the reference ``state_dict``
(mmcv ``MyCustomBaseTransformerLayer``): ``attentions.0``, ``norms.{0,1}``,
``ffns.0.layers.{0.0,1}``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import SpatialCrossAttention
from .config import VERConfig
from .layers import Dense, Dropout, LayerNorm


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
    """cross_attn -> norm -> ffn -> norm (VoxelFormerLayer active order)."""

    def __init__(self, cfg: VERConfig):
        super().__init__()
        if cfg.use_temporal_self_attn:
            raise NotImplementedError(
                "temporal self-attention is not ported yet (ROADMAP "
                "Queue 1, item 11)")
        self.attentions = nn.ModuleList([SpatialCrossAttention(
            cfg.embed_dims, cfg.num_heads, cfg.num_levels,
            cfg.sca_num_points, cfg.dtype, cfg.sca_query_capacity,
            cfg.dropout_rate)])
        self.norms = nn.ModuleList([LayerNorm(cfg.embed_dims, cfg.dtype),
                                    LayerNorm(cfg.embed_dims, cfg.dtype)])
        self.ffns = nn.ModuleList([FFN(cfg.embed_dims, cfg.ffn_dim,
                                       cfg.dtype, cfg.dropout_rate)])

    def forward(self, query, value, reference_points_cam, bev_mask,
                spatial_shapes: Sequence[Tuple[int, int]]):
        query = self.attentions[0](query, value, reference_points_cam,
                                   bev_mask, spatial_shapes)
        query = self.norms[0](query)
        query = self.ffns[0](query)
        return self.norms[1](query)


class VoxelEncoder(nn.Module):
    """Stack of ``encoder_layers`` VoxelEncoderLayers.  With
    ``remat_encoder`` each layer runs under ``torch.utils.checkpoint`` when
    gradients are on: its activations are recomputed in the backward
    instead of kept (vln_ver_tpu/models/encoder.py:115-118).  The replay
    restores the default generators, so it redraws the same dropout
    masks."""

    def __init__(self, cfg: VERConfig):
        super().__init__()
        self.remat = cfg.remat_encoder
        self.layers = nn.ModuleList([VoxelEncoderLayer(cfg)
                                     for _ in range(cfg.encoder_layers)])

    def forward(self, bev_query, value, reference_points_cam, bev_mask,
                spatial_shapes: Sequence[Tuple[int, int]]):
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            args = (bev_query, value, reference_points_cam, bev_mask,
                    spatial_shapes)
            bev_query = (checkpoint(layer, *args, use_reentrant=False)
                         if remat else layer(*args))
        return bev_query
