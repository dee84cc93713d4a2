"""DETR-style 3D detection decoder with iterative reference-point
refinement (PyTorch port of ``vln_ver_tpu/models/decoder.py``).

Reference ``VoxelDetectionTransformerDecoder`` (voxel_decoder.py:53-132):
layers of (self_attn, norm, cross_attn, norm, ffn, norm), where cross_attn
is 3D deformable attention over the voxel grid; after each layer that
layer's regression branch refines the 3D reference points in
inverse-sigmoid space, detached between layers (voxel_decoder.py:106-119).
Module names follow mmcv's ``DetrTransformerDecoderLayer``:
``attentions.{0,1}``, ``norms.{0,1,2}``, ``ffns.0``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch import nn

from .attention import MultiheadAttention, VoxelDeformableAttention3D
from .config import VERConfig
from .encoder import FFN
from .layers import LayerNorm


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


class DecoderLayer(nn.Module):
    """self_attn -> norm -> cross_attn -> norm -> ffn -> norm."""

    def __init__(self, cfg: VERConfig):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(cfg.embed_dims, cfg.num_heads,
                               cfg.dropout_rate, cfg.dtype),
            VoxelDeformableAttention3D(cfg.embed_dims, cfg.num_heads,
                                       cfg.num_levels,
                                       cfg.decoder_num_points, cfg.dtype,
                                       cfg.dropout_rate)])
        self.norms = nn.ModuleList([LayerNorm(cfg.embed_dims, cfg.dtype)
                                    for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(cfg.embed_dims, cfg.ffn_dim,
                                       cfg.dtype, cfg.dropout_rate)])

    def forward(self, query, value, query_pos, reference_points,
                spatial_shapes: Sequence[Tuple[int, int, int]]):
        query = self.attentions[0](query, query_pos=query_pos,
                                   key_pos=query_pos)
        query = self.norms[0](query)
        query = self.attentions[1](query, value, reference_points,
                                   spatial_shapes, query_pos=query_pos)
        query = self.norms[1](query)
        query = self.ffns[0](query)
        return self.norms[2](query)


class VoxelDetectionDecoder(nn.Module):
    """Stacked decoder layers with box refinement.  ``reg_branches`` (one
    callable per layer, hidden states (B, nq, C) -> (B, nq, code_size))
    are passed in, as the reference passes the head's ``reg_branches``
    into its decoder."""

    def __init__(self, cfg: VERConfig):
        super().__init__()
        self.layers = nn.ModuleList([DecoderLayer(cfg)
                                     for _ in range(cfg.decoder_layers)])

    def forward(self, query, value, query_pos, reference_points,
                reg_branches: Sequence[Callable],
                spatial_shapes: Sequence[Tuple[int, int, int]]):
        """Returns ``(inter_states (L, B, nq, C), refs_before (L, B, nq, 3),
        raw_preds (L, B, nq, code_size))``; ``refs_before[l]`` is the
        reference fed INTO layer l, what the head's box decode consumes
        (head:587-606)."""
        inter_states, refs_before, raw_preds = [], [], []
        for lid, layer in enumerate(self.layers):
            refs_before.append(reference_points)
            query = layer(query, value, query_pos,
                          reference_points[:, :, None, :], spatial_shapes)
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
