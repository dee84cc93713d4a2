"""Voxel temporal self-attention (TSA): the episodic-memory substrate
(PyTorch port of ``vln_ver_tpu/models/temporal.py``).

Reference ``VoxelTemporalSelfAttention`` (voxel_temporal_self_attention.py:
26-273): the current voxel queries attend, with 3D deformable sampling,
into a 2-slot queue of voxel grids (previous, current).  Offsets and
weights come from the concatenation of the previous grid and the query,
each slot's weights are softmaxed over levels x points, and the two
slots' outputs are averaged before the output projection.

The sampling is the plain ``ops.deform_attn.voxel_deform_attn_3d`` on
every device, as the decoder's 3D attention on a grid of depth above 1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.deform_attn import voxel_deform_attn_3d
from .attention import _offset_grid_init_3d
from .layers import Dense, Dropout


def fold_queue(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Two (B, ...) slot tensors -> (2B, ...), row ``b * 2 + slot``: the
    queue folded into the batch (slot 0 the previous grid)."""
    return torch.stack([prev, cur], dim=1).flatten(0, 1)


def queue_offsets_init(grid: torch.Tensor, num_heads: int,
                       queue: int) -> torch.Tensor:
    """A per-head directional offset grid repeated per queue slot WITHIN
    each head: the offsets' layout is heads-major, (heads, queue, L, P,
    dims) (vln_ver_tpu/models/temporal.py:98-106)."""
    return grid.reshape(num_heads, 1, -1).repeat(1, queue, 1).reshape(-1)


class VoxelTemporalSelfAttention(nn.Module):
    """Reference names: ``value_proj``, ``sampling_offsets``,
    ``attention_weights``, ``output_proj``."""

    def __init__(self, embed_dims: int = 768, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 num_bev_queue: int = 2, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        if num_bev_queue != 2:
            raise ValueError(f"num_bev_queue={num_bev_queue}: the TSA "
                             "queue has two slots (previous, current)")
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.queue = num_bev_queue
        self.dtype = dtype
        n_off = num_bev_queue * num_heads * num_levels * num_points
        self.value_proj = Dense(embed_dims, embed_dims, dtype)
        self.sampling_offsets = Dense(2 * embed_dims, n_off * 3)
        self.attention_weights = Dense(2 * embed_dims, n_off)
        self.output_proj = Dense(embed_dims, embed_dims, dtype)
        self.dropout = Dropout(dropout_rate)

    @torch.no_grad()
    def init_sampling(self) -> None:
        """flax init of the offsets (zero kernel, the 3D directional grid
        per slot within each head) and attention weights (zeros)."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(queue_offsets_init(
            _offset_grid_init_3d(self.num_heads, self.num_levels,
                                 self.num_points), self.num_heads,
            self.queue))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, prev_bev: Optional[torch.Tensor],
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int, int]],
                query_pos: Optional[torch.Tensor] = None,
                frame_query: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, nq, C); prev_bev (B, nq, C) or None; reference_points
        (B, nq, L, 3) normalised voxel centres; frame_query the
        frame-initial voxel grid; shift (B, 3) the normalised ego motion
        of the previous frame's grid.

        The value slots follow the reference: the values never carry
        ``query_pos``; with ``prev_bev`` the current slot is
        ``frame_query`` (the grid stacked once before the layer loop) and
        slot 0's reference points are shifted by ``shift``; without it
        both slots are the layer's incoming query, unshifted.  The
        offsets and weights are predicted from [previous slot, query +
        pos] per sample."""
        bsz, nq, c = query.shape
        heads, levels, points = (self.num_heads, self.num_levels,
                                 self.num_points)
        queue = self.queue
        identity = raw = query
        if query_pos is not None:
            query = query + query_pos
        if prev_bev is not None:
            prev = prev_bev
            cur = frame_query if frame_query is not None else raw
            ref_prev = (reference_points if shift is None else
                        reference_points + shift[:, None, None, :])
        else:
            prev = cur = raw
            ref_prev = reference_points
        value = self.value_proj(fold_queue(prev, cur)).reshape(
            bsz * queue, nq, heads, c // heads)
        q_cat = torch.cat([prev, query], dim=-1).float()

        offsets = self.sampling_offsets(q_cat).reshape(
            bsz, nq, heads, queue, levels, points, 3)
        attn = self.attention_weights(q_cat).reshape(
            bsz, nq, heads, queue, levels * points).softmax(dim=-1)
        # fold the queue into the batch, row b * queue + slot
        attn = attn.reshape(bsz, nq, heads, queue, levels, points).permute(
            0, 3, 1, 2, 4, 5).reshape(bsz * queue, nq, heads, levels, points)
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(
            bsz * queue, nq, heads, levels, points, 3)

        normalizer = torch.tensor([[w, h, d] for (d, h, w) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        ref = fold_queue(ref_prev, reference_points).float()
        locations = (ref[:, :, None, :, None, :]
                     + offsets / normalizer[None, None, None, :, None, :])
        out = voxel_deform_attn_3d(value.float(), spatial_shapes, locations,
                                   attn)
        # average the previous and current slots
        out = out.reshape(bsz, queue, nq, self.embed_dims).mean(dim=1)
        out = self.output_proj(out.to(self.dtype))
        return self.dropout(out) + identity
