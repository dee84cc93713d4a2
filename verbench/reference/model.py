"""The plain reference of the VoxelFormer forward, in fp32.

Written from the published architecture (DefaultRui/VLN-VER,
``projects/mmdet3d_plugin``: VoxelFormer with VoxelFormerOccupancyHead,
vocc.py's layer order) with library calls only: ``F.linear``,
``F.layer_norm``, ``F.grid_sample`` for the bilinear and trilinear taps
(zero padding, ``align_corners=False``), ``F.conv_transpose3d`` for the
upsampler.  It runs over a dict of weights by the published names
(:func:`.arch.make_weights`), one viewpoint or a few at a time.

* The lift is the dense, masked spatial cross-attention: every voxel
  query attends into every camera, contributions of cameras that do not
  see it are dropped, the sum is divided by the number that do.
* The decoder refines its reference points after each layer, detached.
* The occupancy head upsamples the voxel grid with the dense transposed
  convolutions and projects every cell, in the (z, y, x) flat order.

``quant`` (the control): a function applied to both operands of every
matrix product and convolution, such as a round trip through fp8.
``drop`` (training): ``drop(x)`` is called where the published model has
a dropout, in the order the forward reaches them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .arch import Arch

Weights = Dict[str, torch.Tensor]
HEAD = "pts_bbox_head"
TR = f"{HEAD}.transformer"


@contextlib.contextmanager
def true_fp32():
    """fp32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _ident(x):
    return x


class Ref:
    """The reference forward over weights ``w`` of architecture ``a``."""

    def __init__(self, a: Arch, w: Weights,
                 quant: Optional[Callable] = None,
                 drop: Optional[Callable] = None):
        self.a, self.w = a, w
        self.q = quant or _ident
        self.drop = drop or _ident

    # -- building blocks ---------------------------------------------------
    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.w[f"{name}.weight"]),
                        self.w[f"{name}.bias"])

    def norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], self.a.ln_eps)

    def ffn(self, x, pre):
        y = self.drop(F.relu(self.linear(x, f"{pre}.ffns.0.layers.0.0")))
        return x + self.drop(self.linear(y, f"{pre}.ffns.0.layers.1"))

    # -- the lift ------------------------------------------------------------
    def project(self, w2p, shift):
        """Voxel-query centres into every camera: ((B, N, nq, 2) normalised
        image coordinates, (B, N, nq) visibility)."""
        a = self.a
        dev = w2p.device

        def centres(n):
            return (torch.arange(n, dtype=torch.float32, device=dev)
                    + 0.5) / n
        z, y, x = torch.meshgrid(centres(a.bev_z), centres(a.bev_h),
                                 centres(a.bev_w), indexing="ij")
        ref = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
        lo = torch.tensor(a.pc_range[:3], device=dev)
        hi = torch.tensor(a.pc_range[3:], device=dev)
        world = ref * (hi - lo) + lo + shift.float()[:, None, :]
        homo = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
        cam = torch.einsum("bcij,bqj->bcqi", w2p.float(), homo)
        depth = cam[..., 2:3]
        xy = cam[..., :2] / depth.clamp_min(1e-5)
        xy = xy / torch.tensor(a.image_wh, dtype=torch.float32, device=dev)
        vis = ((depth[..., 0] > 1e-5) & (xy[..., 0] > 0) & (xy[..., 0] < 1)
               & (xy[..., 1] > 0) & (xy[..., 1] < 1))
        return torch.clamp(torch.nan_to_num(xy), -1.0, 2.0), vis

    def sca(self, query, value, cam_xy, vis, pre, capture=None):
        """Spatial cross-attention of layer ``pre`` with its residual."""
        a = self.a
        b, nq, e = query.shape
        n, nv = value.shape[1], value.shape[2]
        h, p, hd = a.num_heads, a.sca_num_points, a.head_dim
        da = f"{pre}.attentions.0.deformable_attention"
        v = self.linear(value, f"{da}.value_proj")                # (B,N,nv,E)
        off = self.linear(query, f"{da}.sampling_offsets").reshape(
            b, 1, nq, h, p, 2) / torch.tensor(
                [a.feat_w, a.feat_h], dtype=torch.float32, device=v.device)
        aw = self.linear(query, f"{da}.attention_weights").reshape(
            b, nq, h, p).softmax(dim=-1)
        ref = torch.where(vis[..., None], cam_xy, torch.zeros_like(cam_xy))
        loc = ref[:, :, :, None, None, :] + off                   # B,N,nq,h,p,2
        if capture is not None:
            capture.append((loc.detach(), vis))
        vv = v.reshape(b, n, a.feat_h, a.feat_w, h, hd).permute(
            0, 1, 4, 5, 2, 3).reshape(b * n * h, hd, a.feat_h, a.feat_w)
        grid = (2.0 * loc - 1.0).permute(0, 1, 3, 2, 4, 5).reshape(
            b * n * h, nq, p, 2)
        taps = F.grid_sample(vv, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)                  # (.,hd,nq,p)
        wgt = aw.permute(0, 2, 1, 3)[:, None, :, None]           # B,1,h,1,nq,p
        out = (taps.reshape(b, n, h, hd, nq, p) * wgt).sum(-1)
        out = out.permute(0, 1, 4, 2, 3).reshape(b, n, nq, e)
        slots = (out * vis[..., None]).sum(dim=1)
        count = vis.float().sum(dim=1).clamp_min(1.0)
        x = self.linear(slots / count[..., None],
                        f"{pre}.attentions.0.output_proj")
        return self.drop(x) + query

    def lift(self, features, w2p, shift, capture=None):
        """(B, N, fh, fw, C) features -> (B, bev_num, C) voxel embedding."""
        a = self.a
        b, n, fh, fw, c = features.shape
        value = (features.float().reshape(b, n, fh * fw, c)
                 + self.w[f"{TR}.cams_embeds"][None, :, None]
                 + self.w[f"{TR}.level_embeds"][None, None, 0:1])
        cam_xy, vis = self.project(w2p, shift)
        query = self.w[f"{HEAD}.voxel_embedding.weight"][None].expand(
            b, -1, -1)
        for i in range(a.encoder_layers):
            pre = f"{TR}.encoder.layers.{i}"
            query = self.sca(query, value, cam_xy, vis, pre, capture)
            query = self.norm(query, f"{pre}.norms.0")
            query = self.norm(self.ffn(query, pre), f"{pre}.norms.1")
        return query

    # -- the decoder ----------------------------------------------------------
    def self_attn(self, query, pos, pre):
        a = self.a
        b, nq, e = query.shape
        h, hd = a.num_heads, a.head_dim
        w = self.w[f"{pre}.attn.in_proj_weight"]
        bias = self.w[f"{pre}.attn.in_proj_bias"]
        qk = query + pos

        def heads(x, i):
            y = F.linear(self.q(x), self.q(w[i * e:(i + 1) * e]),
                         bias[i * e:(i + 1) * e])
            return y.reshape(b, nq, h, hd).transpose(1, 2)
        qh, kh, vh = heads(qk, 0), heads(qk, 1), heads(query, 2)
        scores = self.q(qh / math.sqrt(hd)) @ self.q(kh).transpose(-1, -2)
        probs = self.drop(scores.softmax(dim=-1))
        out = (self.q(probs) @ self.q(vh)).transpose(1, 2).reshape(b, nq, e)
        return self.drop(self.linear(out, f"{pre}.attn.out_proj")) + query

    def cross_attn(self, query, pos, value, ref, pre):
        """3D deformable attention over the voxel grid, with residual."""
        a = self.a
        b, nq, e = query.shape
        h, p, hd = a.num_heads, a.decoder_num_points, a.head_dim
        z, y, x = a.bev_z, a.bev_h, a.bev_w
        qq = query + pos
        v = self.linear(value, f"{pre}.value_proj")
        off = self.linear(qq, f"{pre}.sampling_offsets").reshape(
            b, nq, h, p, 3) / torch.tensor([x, y, z], dtype=torch.float32,
                                           device=v.device)
        aw = self.linear(qq, f"{pre}.attention_weights").reshape(
            b, nq, h, p).softmax(dim=-1)
        loc = ref[:, :, None, None, :] + off                     # B,nq,h,p,3
        vv = v.reshape(b, z, y, x, h, hd).permute(0, 4, 5, 1, 2, 3).reshape(
            b * h, hd, z, y, x)
        grid = (2.0 * loc - 1.0).permute(0, 2, 1, 3, 4).reshape(
            b * h, nq, p, 1, 3)
        taps = F.grid_sample(vv, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)[..., 0]         # (.,hd,nq,p)
        wgt = aw.permute(0, 2, 1, 3).reshape(b * h, 1, nq, p)
        out = (taps * wgt).sum(-1).reshape(b, h, hd, nq).permute(
            0, 3, 1, 2).reshape(b, nq, e)
        return self.drop(self.linear(out, f"{pre}.output_proj")) + query

    @staticmethod
    def inverse_sigmoid(x, eps=1e-5):
        x = x.clamp(0.0, 1.0)
        return torch.log(x.clamp_min(eps) / (1.0 - x).clamp_min(eps))

    def cls_branch(self, x, i):
        pre = f"{HEAD}.cls_branches.{i}"
        for j in range(self.a.num_reg_fcs):
            x = F.relu(self.norm(self.linear(x, f"{pre}.{3 * j}"),
                                 f"{pre}.{3 * j + 1}"))
        return self.linear(x, f"{pre}.{3 * self.a.num_reg_fcs}")

    def reg_branch(self, x, i):
        pre = f"{HEAD}.reg_branches.{i}"
        for j in range(self.a.num_reg_fcs):
            x = F.relu(self.linear(x, f"{pre}.{2 * j}"))
        return self.linear(x, f"{pre}.{2 * self.a.num_reg_fcs}")

    def decode(self, bev):
        """(B, bev_num, C) -> (all_cls_scores (L, B, nq, classes),
        all_bbox_preds (L, B, nq, code_size))."""
        a = self.a
        b, e = bev.shape[0], a.embed_dims
        qe = self.w[f"{HEAD}.query_embedding.weight"]
        pos = qe[None, :, :e].expand(b, -1, -1)
        query = qe[None, :, e:].expand(b, -1, -1)
        ref = torch.sigmoid(self.linear(pos, f"{TR}.reference_points"))
        lo, hi = a.pc_range[:3], a.pc_range[3:]
        cls, boxes = [], []
        for i in range(a.decoder_layers):
            pre = f"{TR}.decoder.layers.{i}"
            query = self.norm(self.self_attn(query, pos, f"{pre}.attentions.0"),
                              f"{pre}.norms.0")
            query = self.norm(self.cross_attn(query, pos, bev, ref,
                                              f"{pre}.attentions.1"),
                              f"{pre}.norms.1")
            query = self.norm(self.ffn(query, pre), f"{pre}.norms.2")
            raw = self.reg_branch(query, i)
            xy = torch.sigmoid(raw[..., 0:2]
                               + self.inverse_sigmoid(ref[..., 0:2]))
            zc = torch.sigmoid(raw[..., 4:5]
                               + self.inverse_sigmoid(ref[..., 2:3]))
            boxes.append(torch.cat([
                xy[..., 0:1] * (hi[0] - lo[0]) + lo[0],
                xy[..., 1:2] * (hi[1] - lo[1]) + lo[1], raw[..., 2:4],
                zc * (hi[2] - lo[2]) + lo[2], raw[..., 5:]], dim=-1))
            cls.append(self.cls_branch(query, i))
            # the next layer's reference is this layer's refined centre
            ref = torch.cat([xy, zc], dim=-1).detach()
        return torch.stack(cls), torch.stack(boxes)

    # -- occupancy ------------------------------------------------------------
    def occupancy(self, bev):
        """(B, bev_num, C) -> (B, voxel_num, classes) logits, flat order
        z, y, x."""
        a = self.a
        b, e = bev.shape[0], a.embed_dims
        x = bev.reshape(b, a.bev_z, a.bev_h, a.bev_w, e).permute(0, 4, 1, 2, 3)
        for i in range(a.up_stages):
            x = F.conv_transpose3d(
                self.q(x), self.q(self.w[f"{HEAD}.up_sample.{i}.weight"]),
                self.w[f"{HEAD}.up_sample.{i}.bias"], stride=(1, 2, 2),
                padding=(2, 4, 4), output_padding=(0, 1, 1), dilation=2)
        _, _, z, hy, wx = x.shape
        if a.bev_z == a.occ_zdim:
            occ = self.linear(x.permute(0, 2, 3, 4, 1), f"{HEAD}.occ_proj")
        else:
            occ = self.linear(x.permute(0, 3, 4, 2, 1).reshape(
                b, hy, wx, z * e), f"{HEAD}.occ_proj")
            occ = occ.reshape(b, hy, wx, a.occ_zdim, a.occ_dims).permute(
                0, 3, 1, 2, 4)
        pre = f"{HEAD}.occ_branches"
        for j in range(a.num_occ_fcs):
            occ = F.relu(self.norm(self.linear(occ, f"{pre}.{3 * j}"),
                                   f"{pre}.{3 * j + 1}"))
        occ = self.linear(occ, f"{pre}.{3 * a.num_occ_fcs}")
        return occ.reshape(b, -1, occ.shape[-1])

    def forward(self, features, w2p, shift, only_bev=False, capture=None):
        bev = self.lift(features, w2p, shift, capture)
        if only_bev:
            return {"bev_embed": bev}
        cls, boxes = self.decode(bev)
        return {"bev_embed": bev, "all_cls_scores": cls,
                "all_bbox_preds": boxes,
                "occupancy_preds": self.occupancy(bev)}
