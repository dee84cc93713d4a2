"""VoxelPerceptionTransformer: encoder and decoder (PyTorch port of
``vln_ver_tpu/models/transformer.py``).

``get_voxel_features`` adds the learned camera and level embeddings to the
flattened per-view features, projects the voxel queries into every camera
and runs the voxel encoder; ``forward`` also runs the DETR decoder over the
resulting voxel grid, refining its reference points with the head's
regression branches (reference names: ``pts_bbox_head.reg_branches``).
With ``decoder_on_bev`` the decoder attends a (1, H, W) BEV grid made from
the voxel grid by ``voxel2bev`` (``'mlp'``: Linear, LN, ReLU, Linear, LN,
ReLU over the z-concatenated features, voxel_transformer.py:86-96) or by
the max over z (``'pool'``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .. import geometry
from ..ops.deform_cuda import KERNEL
from ..utils.cuda_graph import GraphCache
from ..utils.profiling import count, span
from .config import VERConfig
from .decoder import VoxelDetectionDecoder
from .encoder import VoxelEncoder
from .layers import Dense, LayerNorm


class RegBranch(nn.Sequential):
    """(Dense, ReLU) x num_fcs, then Dense(code_size) in fp32 (head
    _init_layers :191-196); reference indices 0, 2, ..., 2 * num_fcs.  The
    layout branches have the same structure."""

    def __init__(self, embed_dims: int, code_size: int, num_fcs: int = 2,
                 dtype: torch.dtype = torch.float32):
        layers = []
        for _ in range(num_fcs):
            layers += [Dense(embed_dims, embed_dims, dtype), nn.ReLU()]
        layers.append(Dense(embed_dims, code_size))
        super().__init__(*layers)


class VoxelTransformer(nn.Module):

    def __init__(self, cfg: VERConfig):
        super().__init__()
        self.cfg = cfg
        self.cams_embeds = nn.Parameter(
            torch.empty(cfg.num_cams, cfg.embed_dims))
        self.level_embeds = nn.Parameter(
            torch.empty(cfg.num_levels, cfg.embed_dims))
        self.encoder = VoxelEncoder(cfg)
        # a parallel.mesh.ViewShard when the cameras are split over ranks
        self.views = None
        if not cfg.only_occ:
            if cfg.voxel_2_bev_type not in ("mlp", "pool"):
                raise ValueError(f"unknown voxel_2_bev_type "
                                 f"{cfg.voxel_2_bev_type!r}")
            if cfg.decoder_on_bev and cfg.voxel_2_bev_type == "mlp":
                e, mid = cfg.embed_dims, cfg.embed_dims * cfg.bev_z
                self.voxel2bev = nn.Sequential(
                    Dense(mid, mid, cfg.dtype), LayerNorm(mid, cfg.dtype),
                    nn.ReLU(), Dense(mid, e, cfg.dtype),
                    LayerNorm(e, cfg.dtype), nn.ReLU())
            self.decoder = VoxelDetectionDecoder(cfg)
            # inference forwards on the card replay the decoder (with its
            # queries and the head's reg branches) from CUDA graphs
            self.decoder_graphs = GraphCache(kernels=(KERNEL,),
                                             name="decoder")
            self.reference_points = Dense(cfg.embed_dims, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.cams_embeds.normal_(generator=generator)
        self.level_embeds.normal_(generator=generator)

    @span("ver#encoder")
    def get_voxel_features(self, features: torch.Tensor,
                           bev_queries: torch.Tensor,
                           world2pixel: torch.Tensor,
                           origin_shift: torch.Tensor, prev_bev=None,
                           bev_pos=None, tsa_shift=None):
        """Lift multi-view features into the voxel grid.

        Args:
          features: (B, num_cams, feat_h, feat_w, C) ViT patch features.
          bev_queries: (B, bev_num, C) voxel queries.
          world2pixel: (B, num_cams, 4, 4).
          origin_shift: (B, 3).
          prev_bev, bev_pos, tsa_shift: the TSA's previous voxel grid
            (B, bev_num, C), query positions and slot-0 shift (B, 3) in
            normalised grid units, under ``use_temporal_self_attn``.  No
            shift is zero shift, the reference voxel transformer's
            hard-coded ``[[0., 0., 0.]]`` (voxel_transformer.py:140).
        Returns:
          ((B, bev_num, C) voxel embedding, sca_overflow).  With a query
          capacity K (``sca_query_capacity``, below bev_num)
          ``sca_overflow`` is the number of visible queries beyond K in the
          worst (sample, camera) slot, clamped at 0, as an int64 scalar on
          the device: nonzero means the sparse lift dropped queries, and
          the callers (get_occ, test, train) fail on it.  The dense lift
          drops nothing: the constant 0.
        With ``views`` the inputs hold this rank's block of cameras, and
        the worst slot is the view group's.
        """
        cfg = self.cfg
        b, num_cams, fh, fw, c = features.shape
        dt = cfg.dtype
        # a view rank holds cameras [lo, lo + num_cams) of the viewpoint
        lo = 0 if self.views is None else self.views.index * num_cams
        value = features.reshape(b, num_cams, fh * fw, c).to(dt)
        value = value + self.cams_embeds[None, lo:lo + num_cams, None,
                                         :].to(dt)
        value = value + self.level_embeds[None, None, 0:1, :].to(dt)

        ref3d = geometry.voxel_reference_points(
            cfg.bev_z, cfg.bev_h, cfg.bev_w, device=features.device)
        cam_xy, mask = geometry.project_reference_points(
            ref3d, world2pixel, origin_shift, pc_range=cfg.pc_range)
        # single z-anchor per voxel query (the reference's D == 1 on the
        # voxel path; each query carries its own z)
        cam_xy = cam_xy[:, :, :, None, :]       # (B, cams, nq, 1, 2)
        mask = mask[:, :, :, None]              # (B, cams, nq, 1)

        cap = cfg.sca_query_capacity
        overflow = 0
        if cap and cap < mask.shape[2]:
            per_slot = mask.any(dim=-1).sum(dim=-1)      # (B, cams)
            count("lift#visible_queries",
                  lambda: per_slot.clamp_max(cap).sum())
            count("lift#query_slots", per_slot.numel() * cap)
            visible = per_slot.max()                      # worst slot
            if self.views is not None:
                visible = visible.clone()
                dist.all_reduce(visible, op=dist.ReduceOp.MAX,
                                group=self.views.group)
            overflow = (visible - cap).clamp_min(0)

        embed = self.encoder(bev_queries, value, cam_xy, mask, ((fh, fw),),
                             prev_bev=prev_bev, bev_pos=bev_pos,
                             shift=tsa_shift)
        return embed, overflow

    def forward(self, features: torch.Tensor, bev_queries: torch.Tensor,
                object_query_embed: torch.Tensor, world2pixel: torch.Tensor,
                origin_shift: torch.Tensor, reg_branches: nn.ModuleList,
                prev_bev=None, bev_pos=None, tsa_shift=None):
        """Full encoder + decoder pass.  Under ``no_grad`` or
        ``inference_mode`` on the card, with the modules in ``eval()``, the
        decoder replays from a CUDA graph (``utils.cuda_graph``).

        Returns (voxel_embed (B, bev_num, C), inter_states (L, B, nq, C),
        raw_reg_preds (L, B, nq, code_size), refs_before (L, B, nq, 3),
        sca_overflow)."""
        cfg = self.cfg
        voxel_embed, overflow = self.get_voxel_features(
            features, bev_queries, world2pixel, origin_shift,
            prev_bev=prev_bev, bev_pos=bev_pos, tsa_shift=tsa_shift)
        b = features.shape[0]
        dec_value, grid = voxel_embed, (cfg.bev_z, cfg.bev_h, cfg.bev_w)
        if cfg.decoder_on_bev:
            # collapse z: the decoder attends a (1, H, W) grid
            # (voxel_transformer.py:263-285)
            vol = voxel_embed.reshape(b, cfg.bev_z, cfg.bev_h * cfg.bev_w,
                                      cfg.embed_dims)
            if cfg.voxel_2_bev_type == "mlp":
                dec_value = self.voxel2bev(vol.permute(0, 2, 1, 3).reshape(
                    b, cfg.bev_h * cfg.bev_w, cfg.bev_z * cfg.embed_dims))
            else:
                dec_value = vol.amax(dim=1)
            grid = (1, cfg.bev_h, cfg.bev_w)

        def decode(query_embed, value):
            # the queries are views of the (nq, 2C) table expanded over the
            # batch, so a graph sees them as the eager call does
            query_pos, query = query_embed.chunk(2, dim=-1)
            query_pos = query_pos[None].expand(b, -1, -1).to(cfg.dtype)
            query = query[None].expand(b, -1, -1).to(cfg.dtype)
            init_ref = self.reference_points(query_pos.float()).sigmoid()
            return self.decoder(query, value, query_pos, init_ref,
                                reg_branches, (grid,))

        with span("ver#decoder"):
            inter_states, refs_before, raw_preds = self.decoder_graphs(
                decode, (object_query_embed, dec_value),
                (self.decoder, reg_branches, self.reference_points),
                static=grid)
        return voxel_embed, inter_states, raw_preds, refs_before, overflow
