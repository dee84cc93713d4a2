"""VoxelFormerOccupancyHead: 3D occupancy, 3D boxes and room layout
(PyTorch port of ``vln_ver_tpu/models/head.py``).

Forward modes, chosen by the config as in the reference
(voxelformer_occupancy_head.py:310-625):

* ``only_bev`` (a forward argument): encoder only, the voxel embedding;
* ``only_occ``: encoder and occupancy branch;
* ``only_det``: encoder, decoder and box branches (it takes precedence
  over ``add_layout``, as the reference's ``elif`` does);
* ``add_layout``: boxes, occupancy and layout branches;
* default: boxes and occupancy.

With ``refine_occ`` the voxel grid goes through ``up_sample``, a stack of
transposed convolutions that each double (h, w) (reference names
``up_sample.{i}``), and ``occ_layout`` picks how the upsampled volume
reaches ``occ_proj``:

* ``'zhwc'`` (default): the (Z, H, W, C) layout.  Every odd row or column
  of a stride-2, dilation-2 transposed convolution is its bias alone, so
  ``occ_proj`` and the occupancy MLP run on the even (y, x) cells plus one
  bias cell and the logits are interleaved: the same function as
  ``'zhwc_dense'`` with a quarter of the projection work;
* ``'zhwc_dense'``: every cell projected;
* ``'ref'``: the reference's raw ``.view`` reinterpretations (head:558,
  564), so that weights converted from a reference checkpoint give the
  reference's occupancy.

Occupancy flat order: ``z * (ydim * xdim) + y * xdim + x``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .config import VERConfig
from .decoder import inverse_sigmoid
from .layers import ConvTranspose3d, Dense, LayerNorm
from .transformer import RegBranch, VoxelTransformer


def _bias_init_with_prob(prob: float) -> float:
    return float(-math.log((1 - prob) / prob))


class Embedding(nn.Module):
    """A learned table under the reference name ``<name>.weight``."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(generator=generator)


class _UniformTable(Embedding):
    """flax ``uniform(1.0)`` init: U[0, 1)."""

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.uniform_(generator=generator)


class VoxelLearnedPositionalEncoding(nn.Module):
    """Learned row, column and z embeddings of the full width, summed
    (voxel_positional_embedding.py:10-79): the TSA's ``query_pos``.  Inert
    on the non-temporal path, where it is kept so that reference
    checkpoints load strictly."""

    def __init__(self, cfg: VERConfig):
        super().__init__()
        self.row_embed = _UniformTable(cfg.bev_h, cfg.embed_dims)
        self.col_embed = _UniformTable(cfg.bev_w, cfg.embed_dims)
        self.z_embed = _UniformTable(cfg.bev_z, cfg.embed_dims)
        self.dtype = cfg.dtype

    def forward(self, batch_size: int) -> torch.Tensor:
        """(batch, bev_z*bev_h*bev_w, C), flat order z, h, w."""
        pos = (self.z_embed.weight[:, None, None, :]
               + self.row_embed.weight[None, :, None, :]
               + self.col_embed.weight[None, None, :, :])
        pos = pos.reshape(1, -1, pos.shape[-1]).to(self.dtype)
        return pos.expand(batch_size, -1, -1)


class ClsBranch(nn.Sequential):
    """(Dense, LN, ReLU) x num_fcs, then Dense(out) in fp32 with the
    focal-prior bias (head:183-189, 242-248); reference indices 0, 1, 3, 4,
    ..., 3 * num_fcs.  The occupancy branch has the same structure."""

    def __init__(self, dims: int, out_channels: int, num_fcs: int = 2,
                 dtype: torch.dtype = torch.float32):
        layers = []
        for _ in range(num_fcs):
            layers += [Dense(dims, dims, dtype), LayerNorm(dims, dtype),
                       nn.ReLU()]
        layers.append(Dense(dims, out_channels))
        super().__init__(*layers)

    @torch.no_grad()
    def init_prior(self) -> None:
        self[-1].bias.fill_(_bias_init_with_prob(0.01))


def upsampler_stages(cfg: VERConfig) -> int:
    """Stages of the refine_occ upsampler: each doubles (h, w), so the
    reference's 15 -> 120 is 3 (head:254-258).  Raises where the grids
    are not related by a power of two of at least 2."""
    ratio = cfg.occ_xdim // cfg.bev_w
    stages = max(int(round(math.log2(ratio))), 0) if ratio >= 1 else 0
    if (stages == 0 or cfg.bev_w * 2 ** stages != cfg.occ_xdim
            or cfg.bev_h * 2 ** stages != cfg.occ_ydim):
        raise ValueError(
            "refine_occ requires occ_(x|y)dim = bev_(w|h) * 2^k with k >= 1"
            f" (got bev {cfg.bev_h}x{cfg.bev_w}, occ "
            f"{cfg.occ_ydim}x{cfg.occ_xdim})")
    return stages


class VoxelFormerOccupancyHead(nn.Module):

    def __init__(self, cfg: VERConfig):
        super().__init__()
        if cfg.occ_layout not in ("zhwc", "zhwc_dense", "ref"):
            raise ValueError(f"unknown occ_layout {cfg.occ_layout!r}")
        self.cfg = cfg
        e, dt = cfg.embed_dims, cfg.dtype
        self.voxel_embedding = Embedding(cfg.bev_num, e)
        self.positional_encoding = VoxelLearnedPositionalEncoding(cfg)
        self.transformer = VoxelTransformer(cfg)
        if not cfg.only_occ:
            self.query_embedding = Embedding(cfg.num_query, 2 * e)
            self.query_layout_embedding = Embedding(cfg.num_layout_query,
                                                    2 * e)
            self.cls_branches = nn.ModuleList([
                ClsBranch(e, cfg.num_classes, cfg.num_reg_fcs, dt)
                for _ in range(cfg.decoder_layers)])
            self.reg_branches = nn.ModuleList([
                RegBranch(e, cfg.code_size, cfg.num_reg_fcs, dt)
                for _ in range(cfg.decoder_layers)])
            if cfg.predicts_layout:
                self.layout_branches = nn.ModuleList([
                    RegBranch(e, cfg.code_size, cfg.num_reg_fcs, dt)
                    for _ in range(cfg.decoder_layers)])
        if not cfg.only_det:
            if cfg.bev_z == cfg.occ_zdim:
                self.occ_proj = Dense(e, cfg.occ_dims, dt)
            else:
                self.occ_proj = Dense(cfg.bev_z * e,
                                      cfg.occ_dims * cfg.occ_zdim, dt)
            self.occ_branches = ClsBranch(cfg.occ_dims,
                                          cfg.occupancy_classes,
                                          cfg.num_occ_fcs, dt)
            if cfg.refine_occ:
                self.up_sample = nn.Sequential(*[
                    ConvTranspose3d(e, dt)
                    for _ in range(upsampler_stages(cfg))])

    # -- occupancy -----------------------------------------------------
    def _occ_logits_grid(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, Z, h, w, C) voxel features -> occupancy logits
        (B, occ_z, h, w, n); occ_proj and the MLP are pointwise over the
        (h, w) cells, so any grid of cells goes through."""
        cfg = self.cfg
        if cfg.bev_z == cfg.occ_zdim:
            return self.occ_branches(self.occ_proj(x))
        b, z, h, w, c = x.shape
        # fuse the z axis: (B, h, w, Z*C) -> (B, h, w, occ_z*occ_dims)
        occ = self.occ_proj(x.permute(0, 2, 3, 1, 4).reshape(b, h, w, z * c))
        occ = occ.reshape(b, h, w, cfg.occ_zdim, cfg.occ_dims)
        return self.occ_branches(occ).permute(0, 3, 1, 2, 4)

    def _occupancy_dispatch(self, bev_embed: torch.Tensor) -> torch.Tensor:
        """bev_embed (B, bev_num, C) -> occupancy logits (B, n_vox, n), the
        one owner of the refine_occ / occ_layout dispatch (full forward
        and only_occ emit the same voxel count)."""
        cfg = self.cfg
        b = bev_embed.shape[0]
        z, h, w, c = cfg.bev_z, cfg.bev_h, cfg.bev_w, cfg.embed_dims
        if not cfg.refine_occ:
            logits = self._occ_logits_grid(bev_embed.reshape(b, z, h, w, c))
        elif cfg.occ_layout == "ref":
            return self._occupancy_ref_layout(bev_embed)
        else:
            # (B, Z, H, W, C) -> NCDHW for the convolutions
            up = self.up_sample(
                bev_embed.reshape(b, z, h, w, c).permute(0, 4, 1, 2, 3))
            if cfg.occ_layout == "zhwc_dense":
                logits = self._occ_logits_grid(up.permute(0, 2, 3, 4, 1))
            else:
                logits = self._bias_aware_logits(up)
        return logits.reshape(b, -1, logits.shape[-1])

    def _bias_aware_logits(self, up: torch.Tensor) -> torch.Tensor:
        """up (B, C, Z, H', W') upsampler output -> logits
        (B, occ_z, H', W', n): the even (y, x) cells through occ_proj and
        the MLP, every other cell the logits of the last stage's bias."""
        cfg = self.cfg
        even = up[:, :, :, ::2, ::2].permute(0, 2, 3, 4, 1)
        even_logits = self._occ_logits_grid(even)
        bias = self.up_sample[-1].bias.to(even.dtype).expand(
            1, cfg.bev_z, 1, 1, cfg.embed_dims)
        bias_logits = self._occ_logits_grid(bias)       # (1, oz, 1, 1, n)
        b, oz, h2, w2, n = even_logits.shape
        full = bias_logits.expand(b, oz, 2 * h2, 2 * w2, n).clone()
        full[:, :, ::2, ::2] = even_logits
        return full

    def _occupancy_ref_layout(self, bev_embed: torch.Tensor) -> torch.Tensor:
        """The reference's refine_occ pipeline, per sample: the flat
        (bev_num * C) buffer read as (C, Z, H, W) (head:558), the NCDHW
        conv output read as (Z, occ_x, occ_y, C) (head:564), and the
        z-fused occ_proj in that x/y order (head:570-580)."""
        cfg = self.cfg
        b = bev_embed.shape[0]
        c, z = cfg.embed_dims, cfg.bev_z
        u = self.up_sample(bev_embed.reshape(b, c, z, cfg.bev_h, cfg.bev_w))
        v = u.reshape(b, z, cfg.occ_xdim, cfg.occ_ydim, c)
        if cfg.bev_z == cfg.occ_zdim:
            occ = self.occ_proj(v).reshape(b, -1, cfg.occ_dims)
        else:
            v = v.permute(0, 2, 3, 1, 4).reshape(
                b, cfg.occ_xdim, cfg.occ_ydim, z * c)
            occ = self.occ_proj(v).reshape(
                b, cfg.occ_xdim, cfg.occ_ydim, cfg.occ_zdim, cfg.occ_dims)
            occ = occ.permute(0, 3, 1, 2, 4).reshape(b, -1, cfg.occ_dims)
        return self.occ_branches(occ)

    # -- boxes ---------------------------------------------------------
    @staticmethod
    def _decode_coords(raw_preds, refs_before, value_range):
        """Per-layer box decode (head:587-606): xy and z offsets added to
        the inverse-sigmoid references, sigmoided and scaled to
        ``value_range``; the other code dims stay raw."""
        lo, hi = value_range[:3], value_range[3:]
        xy = (raw_preds[..., 0:2]
              + inverse_sigmoid(refs_before[..., 0:2])).sigmoid()
        z = (raw_preds[..., 4:5]
             + inverse_sigmoid(refs_before[..., 2:3])).sigmoid()
        cx = xy[..., 0:1] * (hi[0] - lo[0]) + lo[0]
        cy = xy[..., 1:2] * (hi[1] - lo[1]) + lo[1]
        cz = z * (hi[2] - lo[2]) + lo[2]
        return torch.cat([cx, cy, raw_preds[..., 2:4], cz,
                          raw_preds[..., 5:]], dim=-1)

    # ------------------------------------------------------------------
    def forward(self, features: torch.Tensor, world2pixel: torch.Tensor,
                origin_shift: torch.Tensor, prev_bev=None, tsa_shift=None,
                only_bev: bool = False) -> dict:
        """features (B, num_cams, feat_h, feat_w, C); world2pixel
        (B, num_cams, 4, 4); origin_shift (B, 3); prev_bev the previous
        frame's voxel grid (B, bev_num, C) and tsa_shift (B, 3) its
        normalised ego motion, both for the TSA queue.  Returns the JAX
        package's dict (the reference's ``outs``, head:615-625); with
        ``only_bev``, ``{"bev_embed": (B, bev_num, C), "sca_overflow"}``."""
        cfg = self.cfg
        b = features.shape[0]
        voxel_queries = self.voxel_embedding.weight[None].expand(
            b, -1, -1).to(cfg.dtype)
        # the TSA's query_pos; inert without it (encoder.py)
        bev_pos = (self.positional_encoding(b)
                   if cfg.use_temporal_self_attn else None)
        temporal = dict(prev_bev=prev_bev, bev_pos=bev_pos,
                        tsa_shift=tsa_shift)
        outs = {"bev_embed": None, "all_cls_scores": None,
                "all_bbox_preds": None, "all_layout_preds": None,
                "occupancy_preds": None, "flow_preds": None}

        if only_bev or cfg.only_occ:
            bev_embed, overflow = self.transformer.get_voxel_features(
                features, voxel_queries, world2pixel, origin_shift,
                **temporal)
            if only_bev:
                return {"bev_embed": bev_embed, "sca_overflow": overflow}
            outs.update(bev_embed=bev_embed, sca_overflow=overflow,
                        occupancy_preds=self._occupancy_dispatch(bev_embed))
            return outs

        bev_embed, hs, raw_preds, refs_before, overflow = self.transformer(
            features, voxel_queries, self.query_embedding.weight,
            world2pixel, origin_shift, self.reg_branches, **temporal)
        outs.update(bev_embed=bev_embed, sca_overflow=overflow)
        outs["all_cls_scores"] = torch.stack([
            branch(hs[lid]) for lid, branch in enumerate(self.cls_branches)])
        outs["all_bbox_preds"] = self._decode_coords(raw_preds, refs_before,
                                                     cfg.pc_range)
        if cfg.predicts_layout:
            raw_layout = torch.stack([
                branch(hs[lid])
                for lid, branch in enumerate(self.layout_branches)])
            outs["all_layout_preds"] = self._decode_coords(
                raw_layout, refs_before, cfg.layout_range)
        if not cfg.only_det:
            outs["occupancy_preds"] = self._occupancy_dispatch(bev_embed)
        return outs
