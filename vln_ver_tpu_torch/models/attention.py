"""Attention modules (PyTorch port of ``vln_ver_tpu/models/attention.py``).

* :class:`CamDeformableAttention` is the reference MSDeformableAttention3D
  (spatial_cross_attention.py:179-402): per-camera 2D deformable
  attention whose sampling points are shared across the query's Z anchors.
* :class:`SpatialCrossAttention` runs the attention dense over all queries
  for every camera and masks invisible contributions before the sum: the
  same result as the reference's per-camera rebatch and scatter-add, with
  static shapes.  With a query capacity K it runs the attention on each
  camera's first K visible queries only (the sparse lift).
* :class:`VoxelDeformableAttention3D` is the decoder's cross-attention,
  the reference VoxelCustomMSDeformableAttention (voxel_decoder.py:
  135-358): 3D offsets, trilinear sampling over the (z, h, w) voxel grid
  (bilinear over a depth-1 grid), output projection and residual.
* :class:`MultiheadAttention` is mmcv's wrapper around
  ``nn.MultiheadAttention`` (the decoder's self-attention).

Module and parameter names follow the reference ``state_dict``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.nn.functional import all_reduce

from ..ops.deform_attn import voxel_deform_attn_3d
from ..ops.deform_cuda import ms_deform_attn_2d_fused
from .layers import Dense, Dropout


def _offset_grid_init_2d(num_heads: int, num_levels: int,
                         num_points: int) -> torch.Tensor:
    """Directional bias init of the 2D sampling offsets
    (spatial_cross_attention.py:255-269)."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (
        2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    scale = torch.arange(1, num_points + 1,
                         dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


def _offset_grid_init_3d(num_heads: int, num_levels: int,
                         num_points: int) -> torch.Tensor:
    """3D variant: offsets seeded with (cos, sin, cos + sin)
    (voxel_decoder.py:212-226)."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (
        2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin(),
                        thetas.cos() + thetas.sin()], dim=-1)
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    scale = torch.arange(1, num_points + 1,
                         dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


class CamDeformableAttention(nn.Module):
    """Per-camera 2D deformable attention (reference
    MSDeformableAttention3D); no output projection (the caller does it).

    The sampling offsets and attention weights depend only on the query,
    so they are computed once per sample on ``(B, nq, C)`` in fp32 and
    broadcast over the cameras."""

    def __init__(self, embed_dims: int = 768, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.dtype = dtype
        self.value_proj = Dense(embed_dims, embed_dims, dtype)
        self.sampling_offsets = Dense(
            embed_dims, num_heads * num_levels * num_points * 2)
        self.attention_weights = Dense(
            embed_dims, num_heads * num_levels * num_points)

    @torch.no_grad()
    def init_sampling(self) -> None:
        """flax init of the offsets (zero kernel, directional grid bias)
        and attention weights (zeros); draws no random numbers."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(_offset_grid_init_2d(
            self.num_heads, self.num_levels, self.num_points))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                gather_idx: torch.Tensor = None) -> torch.Tensor:
        """query (B, nq, C); value (B, num_cam, nv, C);
        reference_points (B, num_cam, nq', num_Z_anchors, 2) in [0, 1].
        Without ``gather_idx`` nq' = nq and every camera attends from every
        query.  With ``gather_idx`` (B, num_cam, K) int64, camera c of
        sample b attends from queries ``gather_idx[b, c]`` only, nq' = K,
        and ``reference_points`` holds those queries' points.
        Returns (B, num_cam, nq', C) in the compute dtype."""
        bsz, nq, _ = query.shape
        num_cam, nv = value.shape[1], value.shape[2]
        heads, levels, points = (self.num_heads, self.num_levels,
                                 self.num_points)
        hd = self.embed_dims // heads

        value = self.value_proj(value).reshape(bsz * num_cam, nv, heads, hd)

        offsets = self.sampling_offsets(query.float())
        attn = self.attention_weights(query.float()).reshape(
            bsz, nq, heads, levels * points).softmax(dim=-1)
        if gather_idx is not None:
            # the K rows of each camera; within one (sample, camera) the
            # indices are distinct, so the gather's backward adds into no
            # element twice
            nq_eff = gather_idx.shape[-1]

            def gather(x):
                x = x.reshape(bsz, 1, nq, -1).expand(bsz, num_cam, nq, -1)
                idx = gather_idx[..., None].expand(-1, -1, -1, x.shape[-1])
                return torch.gather(x, 2, idx)

            offsets = gather(offsets).reshape(bsz, num_cam, nq_eff, heads,
                                              levels, points, 2)
            attn = gather(attn).reshape(bsz * num_cam, nq_eff, heads, levels,
                                        points)
        else:
            nq_eff = nq
            offsets = offsets.reshape(bsz, 1, nq, heads, levels, points, 2)
            attn = attn.reshape(bsz, 1, nq, heads, levels, points).expand(
                bsz, num_cam, nq, heads, levels, points).reshape(
                    bsz * num_cam, nq, heads, levels, points)

        # distribute the P sampling points across the query's Z anchors
        # (spatial_cross_attention.py:352-374); the normaliser is [w, h]
        num_anchors = reference_points.shape[3]
        normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        offsets = offsets / normalizer[None, None, None, None, :, None, :]
        offsets = offsets.reshape(bsz, offsets.shape[1], nq_eff, heads,
                                  levels, points // num_anchors, num_anchors,
                                  2)
        ref = reference_points[:, :, :, None, None, None, :, :].float()
        locations = (ref + offsets).reshape(bsz * num_cam, nq_eff, heads,
                                            levels, points, 2)

        out = ms_deform_attn_2d_fused(value.contiguous(), spatial_shapes,
                                      locations.contiguous(),
                                      attn.contiguous())
        return out.reshape(bsz, num_cam, nq_eff,
                           self.embed_dims).to(self.dtype)


class SpatialCrossAttention(nn.Module):
    """Masked-dense multi-camera spatial cross-attention (reference
    spatial_cross_attention.py:31-176): deformable attention from every
    query into every camera, invisible contributions masked away, the
    camera sum taken in fp32 and divided by the per-query hit count, then
    ``output_proj``, dropout and the residual.

    ``query_capacity`` K > 0 (and below nq) is the capacity-bounded sparse
    lift (vln_ver_tpu/models/attention.py:238-258): each camera runs the
    attention on K query slots, its visible queries in index order and
    then pad rows, and the valid slots are scattered back before the
    camera sum.  Equal to the dense path, term for term, whenever no
    camera sees more than K queries; beyond K the highest-index visible
    queries are dropped, which the transformer's ``sca_overflow``
    reports.

    With ``views`` (a ``parallel.mesh.ViewShard``) the inputs hold this
    rank's cameras only, and the fp32 slot sum and the hit count are
    all-reduced over the view group before the divide: every view rank
    gets the whole lift."""

    def __init__(self, embed_dims: int = 768, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 8,
                 dtype: torch.dtype = torch.float32,
                 query_capacity: int = 0, dropout_rate: float = 0.1):
        super().__init__()
        self.query_capacity = query_capacity
        self.dtype = dtype
        self.deformable_attention = CamDeformableAttention(
            embed_dims, num_heads, num_levels, num_points, dtype)
        self.output_proj = Dense(embed_dims, embed_dims, dtype)
        self.dropout = Dropout(dropout_rate)
        # a parallel.mesh.ViewShard when the cameras are split over ranks
        self.views = None

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                reference_points_cam: torch.Tensor, bev_mask: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, nq, C); value (B, num_cam, nv, C);
        reference_points_cam (B, num_cam, nq, A, 2); bev_mask
        (B, num_cam, nq, A) bool."""
        residual = query
        # zero the reference coords only for queries invisible in ALL
        # anchors of a camera; partially visible queries keep their true
        # per-anchor coords (the reference samples those as they are)
        qmask = bev_mask.any(dim=-1)                          # (B, cam, nq)
        ref = torch.where(qmask[..., None, None], reference_points_cam,
                          torch.zeros((), dtype=reference_points_cam.dtype,
                                      device=reference_points_cam.device))
        nq = query.shape[1]
        cap = self.query_capacity
        if cap and cap < nq:
            # a stable sort of the 0/1 mask, as jax.lax.top_k is stable:
            # the visible queries in index order, then the pad rows
            idx = torch.sort(qmask.to(torch.uint8), dim=-1, descending=True,
                             stable=True).indices[..., :cap]   # (B, cam, K)
            valid = torch.gather(qmask, 2, idx)
            ref_k = torch.gather(ref, 2, idx[..., None, None].expand(
                -1, -1, -1, *ref.shape[3:]))           # (B, cam, K, A, 2)
            out_k = self.deformable_attention(query, value, ref_k,
                                              spatial_shapes, gather_idx=idx)
            contrib = out_k * valid[..., None].to(out_k.dtype)
            # back to the query slots: the K indices of a camera are
            # distinct, so a scatter (no adds, no atomics) into each
            # camera's own rows, then the dense path's fp32 camera sum
            per_cam = torch.zeros(contrib.shape[:2] + (nq, contrib.shape[3]),
                                  dtype=torch.float32, device=contrib.device)
            per_cam = per_cam.scatter(2, idx[..., None].expand_as(contrib),
                                      contrib.float())
            slots = per_cam.sum(dim=1)                          # (B, nq, C)
        else:
            attn_out = self.deformable_attention(query, value, ref,
                                                 spatial_shapes)
            # fp32 cross-camera accumulation
            slots = torch.sum(attn_out * qmask[..., None].to(attn_out.dtype),
                              dim=1, dtype=torch.float32)      # (B, nq, C)
        # per-query camera hit count (spatial_cross_attention.py:170-173)
        count = qmask.float().sum(dim=1)
        if self.views is not None:
            # this rank's cameras only: the slot sums and hit counts of the
            # view group's cameras add up to the whole sum, in one
            # autograd-aware all-reduce (its backward sums the slots'
            # gradients over the group)
            both = all_reduce(torch.cat([slots, count[..., None]], dim=-1),
                              group=self.views.group)
            slots, count = both[..., :-1], both[..., -1].detach()
        count = count.clamp_min(1.0)
        slots = (slots / count[..., None]).to(self.dtype)
        return self.dropout(self.output_proj(slots)) + residual


class VoxelDeformableAttention3D(nn.Module):
    """3D deformable cross-attention of object queries over the voxel grid
    (reference VoxelCustomMSDeformableAttention).  The 3D sampling is the
    plain gather form on every device.  A grid of depth 1 (the reference's
    ``decoder_on_bev`` route) is sampled bilinearly over (x, y) by
    ``ms_deform_attn_2d_fused``: the plain version on the CPU, the
    hand-written kernel on the card.  Output projection, dropout,
    residual."""

    def __init__(self, embed_dims: int = 768, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.dtype = dtype
        self.value_proj = Dense(embed_dims, embed_dims, dtype)
        self.sampling_offsets = Dense(
            embed_dims, num_heads * num_levels * num_points * 3)
        self.attention_weights = Dense(
            embed_dims, num_heads * num_levels * num_points)
        self.output_proj = Dense(embed_dims, embed_dims, dtype)
        self.dropout = Dropout(dropout_rate)
        self._normalizers = {}

    def normalizer(self, spatial_shapes: Sequence[Tuple[int, int, int]],
                   device) -> torch.Tensor:
        """The offset normaliser, (w, h, d) of each level
        (voxel_decoder.py:313-318), (levels, 3) in fp32: built on the
        device once per grid, since a host-to-device copy on every call
        cannot be captured in a CUDA graph; outside inference mode, so
        that a training forward may save it for the backward."""
        key = (tuple(spatial_shapes), device)
        norm = self._normalizers.get(key)
        if norm is None:
            with torch.inference_mode(False):
                norm = torch.tensor([[w, h, d] for (d, h, w)
                                     in spatial_shapes],
                                    dtype=torch.float32, device=device)
            self._normalizers[key] = norm
        return norm

    @torch.no_grad()
    def init_sampling(self) -> None:
        """flax init of the offsets (zero kernel, directional 3D grid
        bias) and attention weights (zeros)."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(_offset_grid_init_3d(
            self.num_heads, self.num_levels, self.num_points))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int, int]],
                query_pos: torch.Tensor = None) -> torch.Tensor:
        """query (B, nq, C); value (B, nv, C); reference_points
        (B, nq, num_levels, 3), normalised (x, y, z)."""
        bsz, nq, _ = query.shape
        nv = value.shape[1]
        heads, levels, points = (self.num_heads, self.num_levels,
                                 self.num_points)
        identity = query
        if query_pos is not None:
            query = query + query_pos

        value = self.value_proj(value).reshape(
            bsz, nv, heads, self.embed_dims // heads)
        offsets = self.sampling_offsets(query).reshape(
            bsz, nq, heads, levels, points, 3)
        attn = self.attention_weights(query).reshape(
            bsz, nq, heads, levels * points).softmax(dim=-1)
        attn = attn.reshape(bsz, nq, heads, levels, points)

        normalizer = self.normalizer(spatial_shapes, query.device)
        locations = (reference_points[:, :, None, :, None, :].float()
                     + offsets / normalizer[None, None, None, :, None, :])

        if all(d == 1 for (d, _, _) in spatial_shapes):
            # decoder_on_bev: a depth-1 grid is sampled in 2D over (x, y)
            # (vln_ver_tpu/models/attention.py:345-362), the function of
            # the single-level kernel; z stays an inert offset component
            shapes_2d = tuple((h, w) for (_, h, w) in spatial_shapes)
            out = ms_deform_attn_2d_fused(
                value.contiguous(), shapes_2d,
                locations[..., :2].contiguous(), attn.contiguous())
        else:
            out = voxel_deform_attn_3d(value.float(), spatial_shapes,
                                       locations, attn)
        return self.dropout(self.output_proj(out.to(self.dtype))) + identity


class _PackedAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its names
    (``in_proj_weight`` (3E, E), ``in_proj_bias``, ``out_proj``), with a
    plain matmul + softmax forward in fp32 for the scores."""

    def __init__(self, embed_dims: int, num_heads: int, dropout: float,
                 dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dims))
        self.out_proj = Dense(embed_dims, embed_dims, dtype)
        self.attn_drop = Dropout(dropout)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax MultiHeadDotProductAttention: lecun-normal q/k/v kernels of
        # fan-in E, zero biases; out_proj is a Dense and resets itself
        std = math.sqrt(1.0 / self.in_proj_weight.shape[1]) \
            / .87962566103423978
        nn.init.trunc_normal_(self.in_proj_weight, std=std, a=-2 * std,
                              b=2 * std, generator=generator)
        self.in_proj_bias.zero_()

    def forward(self, query, key, value):
        """(B, nq, E), (B, nk, E), (B, nk, E) -> (B, nq, E)."""
        dt = self.dtype
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        wq, wk, wv = w.chunk(3)
        bq, bk, bv = b.chunk(3)
        bsz, nq, e = query.shape
        hd = e // self.num_heads

        def heads(x, wi, bi):
            y = F.linear(x.to(dt), wi, bi)
            return y.reshape(bsz, -1, self.num_heads, hd).transpose(1, 2)

        q = heads(query, wq, bq)
        k = heads(key, wk, bk)
        v = heads(value, wv, bv)
        scores = (q.float() / math.sqrt(hd)) @ k.float().transpose(-1, -2)
        probs = self.attn_drop(scores.softmax(dim=-1))
        out = (probs.to(dt) @ v).transpose(1, 2).reshape(bsz, nq, e)
        return self.out_proj(out)


class MultiheadAttention(nn.Module):
    """mmcv's MultiheadAttention wrapper with residual: a pos-less key
    against a pos'd query of the same shape takes the query's positions
    (mmcv's self-attention defaulting), and the deprecated ``dropout``
    sets both the attention-probability dropout and the output dropout
    before the residual (vln_ver_tpu/models/attention.py:379-420); both
    are inert in eval mode."""

    def __init__(self, embed_dims: int = 768, num_heads: int = 8,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = _PackedAttention(embed_dims, num_heads, dropout, dtype)
        self.dropout_layer = Dropout(dropout)

    def forward(self, query, key=None, value=None, query_pos=None,
                key_pos=None):
        identity = query
        if key is None:
            key = query
        if value is None:
            value = key
        if key_pos is None and query_pos is not None \
                and query_pos.shape == key.shape:
            key_pos = query_pos
        if query_pos is not None:
            query = query + query_pos
        if key_pos is not None:
            key = key + key_pos
        out = self.attn(query, key, value)
        return self.dropout_layer(out) + identity
