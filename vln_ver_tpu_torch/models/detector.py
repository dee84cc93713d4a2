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
from ..utils.profiling import span
from .attention import (CamDeformableAttention, SpatialCrossAttention,
                        VoxelDeformableAttention3D, _PackedAttention)
from .config import VERConfig
from .head import ClsBranch, Embedding, VoxelFormerOccupancyHead
from .layers import ConvTranspose3d, Dense
from .temporal import VoxelTemporalSelfAttention
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
                              VoxelDeformableAttention3D,
                              VoxelTemporalSelfAttention)):
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
                origin_shift: torch.Tensor, prev_bev=None, tsa_shift=None,
                only_bev: bool = False) -> dict:
        # an fp32 model is true fp32 for every caller, not only the CLIs
        # that set the flags: the upsampler is a cuDNN convolution
        with span("ver#forward"), fp32_precision(self.cfg.dtype):
            return self.pts_bbox_head(features, world2pixel, origin_shift,
                                      prev_bev=prev_bev, tsa_shift=tsa_shift,
                                      only_bev=only_bev)

    @torch.no_grad()
    def obtain_history_bev(self, features_queue: torch.Tensor,
                           world2pixel_queue: torch.Tensor,
                           origin_shift_queue: torch.Tensor) -> torch.Tensor:
        """Roll the encoder over a frame queue (reference
        obtain_history_bev, voxelformer.py:209-228): each frame's voxel
        grid is computed with the previous frame's in the TSA queue,
        without gradients (JAX's ``stop_gradient``), in eval mode.

        Queues are (B, T, ...); returns the last frame's (B, bev_num, C).
        The TSA's slot-0 shift of frame t is the ego displacement in
        normalised grid units, ``(origin_t - origin_{t-1}) / extent``: a
        world point at normalised r in frame t sits at r + shift in the
        previous frame's grid."""
        pc = torch.tensor(self.cfg.pc_range, dtype=torch.float32,
                          device=origin_shift_queue.device)
        extent = pc[3:] - pc[:3]
        was_training = self.training
        self.eval()
        try:
            prev = None
            for t in range(features_queue.shape[1]):
                shift = (None if prev is None else
                         (origin_shift_queue[:, t].float()
                          - origin_shift_queue[:, t - 1].float()) / extent)
                prev = self(features_queue[:, t], world2pixel_queue[:, t],
                            origin_shift_queue[:, t], prev_bev=prev,
                            tsa_shift=shift, only_bev=True)["bev_embed"]
        finally:
            self.train(was_training)
        return prev


def build_model(cfg: VERConfig, device, seed: int = 0) -> VoxelFormer:
    """A VoxelFormer with random weights from ``seed``, drawn on the CPU
    (so the same seed gives the same weights on every device) and then
    moved to ``device``, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    return VoxelFormer(cfg).init_weights(gen).to(device).eval()
