"""VoxelFormer detector — the top-level model (PyTorch port of
``vln_ver_tpu/models/detector.py``).

A thin wrapper over the head whose parameter names are the reference
``state_dict`` names (``pts_bbox_head.*``).  The public layouts are the
JAX package's: features ``(B, cams, fh, fw, C)``, ``bev_embed``
``(B, bev_num, C)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..runtime import fp32_precision
from .attention import (CamDeformableAttention, SpatialCrossAttention,
                        VoxelDeformableAttention3D, _PackedAttention)
from .config import VERConfig
from .head import ClsBranch, Embedding, VoxelFormerOccupancyHead
from .layers import ConvTranspose3d, Dense
from .transformer import VoxelTransformer


class VoxelFormer(nn.Module):
    """Inputs (one MP3D viewpoint per batch element):
      features:     (B, num_cams, feat_h, feat_w, in_channels)
      world2pixel:  (B, num_cams, 4, 4)
      origin_shift: (B, 3)
    """

    def __init__(self, cfg: VERConfig):
        super().__init__()
        self.cfg = cfg
        self.pts_bbox_head = VoxelFormerOccupancyHead(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VoxelFormer":
        """Fill every parameter from ``generator`` with the flax
        initialisers' distributions: lecun-normal kernels (the upsampler's
        of fan-in 75 * C) with zero biases, normal(1.0) tables, the zero
        kernels and directional grid biases of the sampling offsets and
        the focal-prior biases of the class and occupancy branches;
        LayerNorms keep ones and zeros."""
        for m in self.modules():
            if isinstance(m, (Dense, Embedding, VoxelTransformer,
                              ConvTranspose3d, _PackedAttention)):
                m.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, (CamDeformableAttention,
                              VoxelDeformableAttention3D)):
                m.init_sampling()
            elif isinstance(m, ClsBranch):
                m.init_prior()
        return self

    def shard_views(self, views) -> "VoxelFormer":
        """Split the lift's cameras over ranks: ``views`` is a
        ``parallel.mesh.ViewShard`` (None: every camera here).  The inputs
        then hold this rank's contiguous block of cameras, and the lift's
        camera sums are all-reduced over the view group."""
        self.pts_bbox_head.transformer.views = views
        for m in self.modules():
            if isinstance(m, SpatialCrossAttention):
                m.views = views
        return self

    def forward(self, features: torch.Tensor, world2pixel: torch.Tensor,
                origin_shift: torch.Tensor, only_bev: bool = False) -> dict:
        # an fp32 model is true fp32 for every caller, not only the CLIs
        # that set the flags: the upsampler is a cuDNN convolution
        with fp32_precision(self.cfg.dtype):
            return self.pts_bbox_head(features, world2pixel, origin_shift,
                                      only_bev=only_bev)


def build_model(cfg: VERConfig, device, seed: int = 0) -> VoxelFormer:
    """A VoxelFormer with random weights from ``seed``, drawn on the CPU
    (so the same seed gives the same weights on every device) and then
    moved to ``device``, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    return VoxelFormer(cfg).init_weights(gen).to(device).eval()
