"""Deformable attention in plain PyTorch, gather form.

* :func:`ms_deform_attn_2d` defines the semantics of the reference's
  ``ms_deform_attn`` (mmcv's ``multi_scale_deformable_attn_pytorch``, used
  by the encoder's spatial cross-attention); it is what the CPU takes and
  what the CUDA kernel in :mod:`.deform_cuda` is held against.
* :func:`voxel_deform_attn_3d` is the decoder's 3D deformable attention
  over the voxel grid (trilinear taps), port of
  ``vln_ver_tpu/ops/deform_attn.py:238-291``; it runs as it is on every
  device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .sampling import bilinear_sample_2d, trilinear_sample_3d


def ms_deform_attn_2d(value: torch.Tensor,
                      spatial_shapes: Sequence[Tuple[int, int]],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """2D multi-scale deformable attention.

    Args:
      value: ``(bs, num_value, num_heads, head_dim)``; ``num_value`` is the
        concatenation of all level maps flattened row-major (h, w).
      spatial_shapes: per-level ``(h, w)``.
      sampling_locations: ``(bs, num_query, num_heads, num_levels,
        num_points, 2)``, (x, y) normalised to [0, 1].
      attention_weights: ``(bs, num_query, num_heads, num_levels,
        num_points)``, already softmaxed over levels*points.

    Returns:
      ``(bs, num_query, num_heads * head_dim)`` in the value dtype, summed
      in fp32.
    """
    bs, num_value, num_heads, head_dim = value.shape
    num_query = sampling_locations.shape[1]
    total = sum(h * w for h, w in spatial_shapes)
    if total != num_value:
        raise ValueError(f"spatial_shapes {spatial_shapes} cover {total} "
                         f"values, the value tensor has {num_value}")

    v32 = value.float()
    out = torch.zeros((bs, num_heads, num_query, head_dim),
                      dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        vl = v32[:, start:start + h * w]                     # (bs, hw, H, d)
        start += h * w
        vl = vl.permute(0, 2, 1, 3).reshape(bs, num_heads, h, w, head_dim)
        loc = sampling_locations[:, :, :, lvl].float()        # (bs,nq,H,P,2)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        # -> (bs, H, nq*P)
        x = x.permute(0, 2, 1, 3).reshape(bs, num_heads, -1)
        y = y.permute(0, 2, 1, 3).reshape(bs, num_heads, -1)
        sampled = bilinear_sample_2d(vl, x, y)                # (bs,H,nq*P,d)
        sampled = sampled.reshape(bs, num_heads, num_query, -1, head_dim)
        wgt = attention_weights[:, :, :, lvl].float().permute(0, 2, 1, 3)
        out = out + torch.sum(sampled * wgt[..., None], dim=-2)
    out = out.permute(0, 2, 1, 3).reshape(bs, num_query,
                                          num_heads * head_dim)
    return out.to(value.dtype)


def voxel_deform_attn_3d(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """3D deformable attention over a voxel grid (trilinear taps).

    Args:
      value: ``(bs, num_value, num_heads, head_dim)``, levels concatenated,
        each flattened (d, h, w) row-major.
      spatial_shapes: per-level ``(d, h, w)``.
      sampling_locations: ``(bs, num_query, num_heads, num_levels,
        num_points, 3)``, (x, y, z) normalised to [0, 1].
      attention_weights: ``(bs, num_query, num_heads, num_levels,
        num_points)``.

    A depth-1 level samples bilinearly on its one plane (the reference's
    2D route for ``decoder_on_bev``): a trilinear tap there would scale
    features by a z-dependent 0.5-1.0 factor.

    Returns:
      ``(bs, num_query, num_heads * head_dim)`` in the value dtype.
    """
    bs, num_value, num_heads, head_dim = value.shape
    num_query = sampling_locations.shape[1]
    total = sum(d * h * w for d, h, w in spatial_shapes)
    if total != num_value:
        raise ValueError(f"spatial_shapes {spatial_shapes} cover {total} "
                         f"values, the value tensor has {num_value}")

    out = torch.zeros((bs, num_heads, num_query, head_dim),
                      dtype=value.dtype, device=value.device)
    start = 0
    for lvl, (d, h, w) in enumerate(spatial_shapes):
        vl = value[:, start:start + d * h * w]
        start += d * h * w
        vl = vl.permute(0, 2, 1, 3).reshape(bs, num_heads, d, h, w,
                                            head_dim)
        loc = sampling_locations[:, :, :, lvl]              # (bs,nq,H,P,3)

        def flat(coord):                                    # -> (bs,H,nq*P)
            return coord.permute(0, 2, 1, 3).reshape(bs, num_heads, -1)

        x = flat(loc[..., 0] * w - 0.5)
        y = flat(loc[..., 1] * h - 0.5)
        if d == 1:
            sampled = bilinear_sample_2d(vl[:, :, 0], x, y)
        else:
            sampled = trilinear_sample_3d(vl, x, y,
                                          flat(loc[..., 2] * d - 0.5))
        sampled = sampled.reshape(bs, num_heads, num_query, -1, head_dim)
        wgt = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3)
        out = out + torch.sum(sampled * wgt[..., None].to(value.dtype),
                              dim=-2)
    return out.permute(0, 2, 1, 3).reshape(bs, num_query,
                                           num_heads * head_dim)
