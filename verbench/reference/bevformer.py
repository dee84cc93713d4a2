"""BEVFormer-base: the architecture a configuration file describes, its
weights by upstream's names, and its plain reference forward in fp32.

Written from fundamentalvision/BEVFormer (``projects/configs/bevformer/
bevformer_base.py``; ``projects/mmdet3d_plugin/bevformer``: ``BEVFormer``,
``BEVFormerHead``, ``PerceptionTransformer``, ``BEVFormerEncoder`` and
``BEVFormerLayer``, ``TemporalSelfAttention``, ``SpatialCrossAttention``
with ``MSDeformableAttention3D``, ``DetectionTransformerDecoder`` with
``CustomMSDeformableAttention``) with library calls only: ``F.linear``,
``F.layer_norm``, ``F.grid_sample`` for every bilinear tap (upstream's
``multi_scale_deformable_attn_pytorch``, level by level) and for the
rotation of the previous BEV.  Nothing here imports the program.

* The spatial cross-attention is dense and masked: every BEV query
  attends into every camera, in blocks of queries, and a camera that sees
  none of the query's pillar anchors adds nothing; the sum is divided by
  the number of cameras that do (upstream's rebatch and scatter-add over
  each camera's visible queries, the same sum).
* :class:`Video` is upstream's ``BEVFormer.forward_test``: a new scene
  drops ``prev_bev``; can-bus [:3] and [-1] become deltas from the
  previous frame, 0 at a scene's start; ``bev_embed`` is the next
  ``prev_bev``.
* Dropout is the identity (inference).

Departures from upstream, each also in the configuration's
``departures``:

* The image backbone (ResNet-101 with DCNv2) and the FPN neck are cut:
  the forward starts at the neck's four 256-channel maps per camera.
* ``rotate_prev_bev`` resamples bilinearly; upstream's torchvision
  ``rotate`` takes the nearest pixel.  The grid is torchvision's.
* LayerNorm eps 1e-6 (the configuration's ``reference.layer_norm_eps``,
  the program's flax eps); upstream's mmcv and torch LayerNorms use 1e-5.
* The lidar-to-image matrices are the program's ``world2pixel`` with a
  zero ``origin_shift``, and normalised by the padded image (1600, 928),
  as upstream's ``img_shape``; pixel coordinates beyond the depth clamp
  are clipped to [-1, 2] (upstream divides by 1e-5): both lie outside
  every map, so no tap moves.

``Ref(a, w)`` runs over a dict of weights by upstream's names
(:func:`make_weights`, ``pts_bbox_head.*``).  The control (TF32) is the
same code with TF32 on.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .arch import _grid_bias, _stream

HEAD = "pts_bbox_head"
TR = f"{HEAD}.transformer"
Weights = Dict[str, torch.Tensor]


class Arch:
    """Sizes of one BEVFormer configuration (the file's ``model`` group
    holds the program's ``BEV2DConfig`` fields as they are run, ``head``
    the head's class and box code sizes)."""

    def __init__(self, spec: Dict):
        self.spec = spec
        m = spec["model"]
        self.m = m
        self.head = dict(spec.get("head", {}))
        ref = spec.get("reference", {})
        self.ln_eps = float(ref.get("layer_norm_eps", 1e-6))
        for key in ("bev_h", "bev_w", "embed_dims", "num_heads",
                    "encoder_layers", "decoder_layers", "ffn_dim",
                    "num_query", "num_points_in_pillar", "sca_num_points",
                    "tsa_num_points", "decoder_num_points", "num_levels",
                    "num_cams", "in_channels", "canbus_dims",
                    "sca_query_capacity"):
            setattr(self, key, int(m[key]))
        self.num_classes = int(self.head.get("num_classes", 10))
        self.code_size = int(self.head.get("code_size", 10))
        self.pc_range = tuple(float(v) for v in m["pc_range"])
        self.image_wh = tuple(float(v) for v in m["image_wh"])
        self.level_shapes: Tuple[Tuple[int, int], ...] = tuple(
            (int(h), int(w)) for h, w in m["feat_shapes"])
        self.dtype = m["dtype"]
        for flag in ("use_shift", "use_can_bus", "can_bus_norm",
                     "rotate_prev_bev", "fpn_inputs"):
            setattr(self, flag, bool(m[flag]))
        if len(self.level_shapes) != self.num_levels:
            raise ValueError("feat_shapes must give num_levels levels")
        if not self.fpn_inputs or self.in_channels != self.embed_dims:
            raise ValueError("the reference starts at the FPN's maps, "
                             "embed_dims channels a level (fpn_inputs)")
        if self.dtype != "float32":
            raise ValueError("the reference covers the fp32 model")

    @property
    def head_dim(self) -> int:
        return self.embed_dims // self.num_heads

    @property
    def bev_num(self) -> int:
        return self.bev_h * self.bev_w

    @property
    def value_rows(self) -> int:
        """A camera's value rows, every level's h * w."""
        return sum(h * w for h, w in self.level_shapes)

    @property
    def lift_queries(self) -> int:
        """Query slots a camera's lift attends from."""
        cap = self.sca_query_capacity
        return cap if 0 < cap < self.bev_num else self.bev_num


Spec = Tuple[str, Tuple[int, ...], str]


def param_specs(a: Arch) -> List[Spec]:
    """(name, shape, kind) of every parameter, by upstream's names, in a
    fixed order."""
    e, h, f = a.embed_dims, a.num_heads, a.ffn_dim
    out: List[Spec] = []

    def lin(name, n_out, n_in, wkind="linear", bkind="bias"):
        out.append((f"{name}.weight", (n_out, n_in), wkind))
        out.append((f"{name}.bias", (n_out,), bkind))

    def norm(name, n):
        out.append((f"{name}.weight", (n,), "ln_weight"))
        out.append((f"{name}.bias", (n,), "bias"))

    def ffn(pre):
        lin(f"{pre}.ffns.0.layers.0.0", f, e)
        lin(f"{pre}.ffns.0.layers.1", e, f)

    out.append((f"{HEAD}.bev_embedding.weight", (a.bev_num, e), "table"))
    out.append((f"{HEAD}.query_embedding.weight", (a.num_query, 2 * e),
                "table"))
    out.append((f"{HEAD}.positional_encoding.row_embed.weight",
                (a.bev_h, e // 2), "table"))
    out.append((f"{HEAD}.positional_encoding.col_embed.weight",
                (a.bev_w, e // 2), "table"))
    out.append((f"{TR}.level_embeds", (a.num_levels, e), "table"))
    out.append((f"{TR}.cams_embeds", (a.num_cams, e), "table"))
    if a.use_can_bus:
        lin(f"{TR}.can_bus_mlp.0", e // 2, a.canbus_dims)
        lin(f"{TR}.can_bus_mlp.2", e, e // 2)
        if a.can_bus_norm:
            norm(f"{TR}.can_bus_mlp.norm", e)
    tsa_p, sca_p = a.tsa_num_points, a.sca_num_points
    for i in range(a.encoder_layers):
        pre = f"{TR}.encoder.layers.{i}"
        tsa = f"{pre}.attentions.0"
        lin(f"{tsa}.sampling_offsets", 2 * h * tsa_p * 2, 2 * e, "offset",
            "offset_bias_tsa")
        lin(f"{tsa}.attention_weights", 2 * h * tsa_p, 2 * e)
        lin(f"{tsa}.value_proj", e, e)
        lin(f"{tsa}.output_proj", e, e)
        da = f"{pre}.attentions.1.deformable_attention"
        lin(f"{da}.sampling_offsets", h * a.num_levels * sca_p * 2, e,
            "offset", "offset_bias_sca")
        lin(f"{da}.attention_weights", h * a.num_levels * sca_p, e)
        lin(f"{da}.value_proj", e, e)
        lin(f"{pre}.attentions.1.output_proj", e, e)
        for j in range(3):
            norm(f"{pre}.norms.{j}", e)
        ffn(pre)
    for i in range(a.decoder_layers):
        pre = f"{TR}.decoder.layers.{i}"
        out.append((f"{pre}.attentions.0.attn.in_proj_weight", (3 * e, e),
                    "linear"))
        out.append((f"{pre}.attentions.0.attn.in_proj_bias", (3 * e,),
                    "bias"))
        lin(f"{pre}.attentions.0.attn.out_proj", e, e)
        ca = f"{pre}.attentions.1"
        lin(f"{ca}.sampling_offsets", h * a.decoder_num_points * 2, e,
            "offset", "offset_bias_dec")
        lin(f"{ca}.attention_weights", h * a.decoder_num_points, e)
        lin(f"{ca}.value_proj", e, e)
        lin(f"{ca}.output_proj", e, e)
        for j in range(3):
            norm(f"{pre}.norms.{j}", e)
        ffn(pre)
    lin(f"{TR}.reference_points", 3, e)
    for i in range(a.decoder_layers):
        pre = f"{HEAD}.cls_branches.{i}"
        for j in range(2):
            lin(f"{pre}.{3 * j}", e, e)
            norm(f"{pre}.{3 * j + 1}", e)
        lin(f"{pre}.6", a.num_classes, e, "linear", "cls_prior")
    for i in range(a.decoder_layers):
        pre = f"{HEAD}.reg_branches.{i}"
        for j in range(2):
            lin(f"{pre}.{2 * j}", e, e)
        lin(f"{pre}.4", a.code_size, e)
    return out


# spread of each kind: a multiple of 1 / sqrt(fan-in) for kernels
_KERNEL_GAIN = {"linear": 1.0, "offset": 0.5}


def _offset_bias(heads: int, groups: int, points: int) -> torch.Tensor:
    """Upstream's init of the 2D offsets' bias: head h's direction scaled
    by 1..points, repeated over ``groups`` (levels, or queue slots x
    levels), laid out (heads, groups, points, 2)."""
    g = _grid_bias(heads, points, 2).reshape(heads, 1, points, 2)
    return g.expand(heads, groups, points, 2).reshape(-1)


def make_weights(a: Arch, seed: int, device) -> Weights:
    """Every parameter in fp32 on ``device``, drawn from ``seed``: one
    standard-normal draw of a ``torch.Generator`` on the device for all of
    them, then scaled in place per kind.  The same seed gives the same
    tensors on the same device."""
    specs = param_specs(a)
    total = sum(math.prod(s) for _, s, _ in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream(seed, 1))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    h = a.num_heads
    biases = {"offset_bias_tsa": _offset_bias(h, 2, a.tsa_num_points),
              "offset_bias_sca": _offset_bias(h, a.num_levels,
                                              a.sca_num_points),
              "offset_bias_dec": _offset_bias(h, 1, a.decoder_num_points)}
    out, off = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if kind in _KERNEL_GAIN:
            t.mul_(_KERNEL_GAIN[kind] / math.sqrt(shape[1]))
        elif kind == "bias":
            t.mul_(0.02)
        elif kind == "ln_weight":
            t.mul_(0.1).add_(1.0)
        elif kind in biases:
            t.copy_(biases[kind])
        elif kind == "cls_prior":
            # the focal prior of the published init, bias_init_with_prob(0.01)
            t.fill_(-math.log(99.0))
        elif kind != "table":
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = t
    return out


def msda(value: torch.Tensor, shapes, loc: torch.Tensor,
         attn: torch.Tensor) -> torch.Tensor:
    """Upstream's ``multi_scale_deformable_attn_pytorch``: value (bs, nv,
    heads, d), loc (bs, nq, heads, L, P, 2) in [0, 1], attn (bs, nq,
    heads, L, P) -> (bs, nq, heads * d)."""
    bs, _, heads, d = value.shape
    nq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    grids = 2 * loc - 1
    out = None
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].flatten(2).transpose(1, 2)
        v = v.reshape(bs * heads, d, h, w)
        start += h * w
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        taps = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                             align_corners=False)          # (bs*H, d, nq, P)
        wl = attn[:, :, :, lvl].transpose(1, 2).reshape(bs * heads, 1, nq,
                                                          P)
        part = (taps * wl).sum(-1)
        out = part if out is None else out + part
    return out.view(bs, heads * d, nq).transpose(1, 2)


class Ref:
    """The reference forward over weights ``w`` of architecture ``a``."""

    # queries a block of the dense spatial cross-attention
    BLOCK = 8192

    def __init__(self, a: Arch, w: Weights):
        self.a, self.w = a, w

    # -- building blocks ---------------------------------------------------
    def linear(self, x, name):
        return F.linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    def norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], self.a.ln_eps)

    def ffn(self, x, pre):
        y = F.relu(self.linear(x, f"{pre}.ffns.0.layers.0.0"))
        return x + self.linear(y, f"{pre}.ffns.0.layers.1")

    # -- geometry ----------------------------------------------------------
    def ref_2d(self, device):
        """(1, h*w, 1, 2) BEV cell centres (x, y) in [0, 1]."""
        a = self.a
        ys, xs = torch.meshgrid(
            torch.linspace(0.5, a.bev_h - 0.5, a.bev_h, device=device),
            torch.linspace(0.5, a.bev_w - 0.5, a.bev_w, device=device),
            indexing="ij")
        ref = torch.stack((xs.reshape(-1) / a.bev_w,
                           ys.reshape(-1) / a.bev_h), -1)
        return ref[None, :, None]

    def point_sampling(self, lidar2img):
        """Upstream's ``point_sampling`` of the pillar anchors:
        (cams, nq, D, 2) normalised image coordinates and (cams, nq, D)
        visibility, for batch 1."""
        a = self.a
        dev = lidar2img.device
        z = a.pc_range[5] - a.pc_range[2]
        D = a.num_points_in_pillar
        zs = torch.linspace(0.5, z - 0.5, D, device=dev) / z
        xy = self.ref_2d(dev)[0, :, 0]                         # (nq, 2)
        pts = torch.cat([xy[None].expand(D, -1, -1),
                         zs[:, None, None].expand(-1, xy.shape[0], 1)], -1)
        pc = a.pc_range
        pts = torch.stack([pts[..., 0] * (pc[3] - pc[0]) + pc[0],
                           pts[..., 1] * (pc[4] - pc[1]) + pc[1],
                           pts[..., 2] * (pc[5] - pc[2]) + pc[2],
                           torch.ones_like(pts[..., 0])], -1)  # (D, nq, 4)
        cam = torch.einsum("cij,dqj->cqdi", lidar2img[0].float(), pts)
        eps = 1e-5
        mask = cam[..., 2] > eps
        uv = cam[..., 0:2] / torch.clamp(cam[..., 2:3], min=eps)
        uv = uv / torch.tensor(a.image_wh, device=dev)
        mask = (mask & (uv[..., 1] > 0.0) & (uv[..., 1] < 1.0)
                & (uv[..., 0] < 1.0) & (uv[..., 0] > 0.0))
        uv = torch.clamp(torch.nan_to_num(uv), -1.0, 2.0)
        return uv, mask

    # -- attentions --------------------------------------------------------
    def tsa(self, query, pos, prev_bev, frame_query, ref_2d, shift_ref, pre):
        """``TemporalSelfAttention`` (batch 1): the (prev, current) queue,
        offsets and weights from [value[:bs], query + pos], the slots'
        outputs averaged."""
        a = self.a
        nq, e = query.shape[1], a.embed_dims
        heads, P = a.num_heads, a.tsa_num_points
        identity = query
        if prev_bev is None:
            value = torch.cat([query, query], 0)
            ref = torch.cat([ref_2d, ref_2d], 0)
        else:
            value = torch.cat([prev_bev, frame_query], 0)
            ref = torch.cat([shift_ref, ref_2d], 0)
        q = torch.cat([value[:1], query + pos], -1)
        v = self.linear(value, f"{pre}.value_proj").reshape(2, nq, heads,
                                                            e // heads)
        off = self.linear(q, f"{pre}.sampling_offsets").view(
            1, nq, heads, 2, 1, P, 2)
        att = self.linear(q, f"{pre}.attention_weights").view(
            1, nq, heads, 2, P).softmax(-1).view(1, nq, heads, 2, 1, P)
        att = att.permute(0, 3, 1, 2, 4, 5).reshape(2, nq, heads, 1, P)
        off = off.permute(0, 3, 1, 2, 4, 5, 6).reshape(2, nq, heads, 1, P, 2)
        norm = torch.tensor([[a.bev_w, a.bev_h]], dtype=torch.float32,
                            device=query.device)
        loc = ref[:, :, None, :, None, :] + off / norm[None, None, None, :,
                                                       None, :]
        out = msda(v, ((a.bev_h, a.bev_w),), loc, att)      # (2, nq, e)
        out = out.mean(0, keepdim=True)
        return self.linear(out, f"{pre}.output_proj") + identity

    def sca(self, query, value, uv, mask, pre):
        """``SpatialCrossAttention`` with ``MSDeformableAttention3D``
        (batch 1), dense and masked over blocks of queries."""
        a = self.a
        nq, e = query.shape[1], a.embed_dims
        heads, L, P, D = (a.num_heads, a.num_levels, a.sca_num_points,
                          a.num_points_in_pillar)
        da = f"{pre}.deformable_attention"
        v = self.linear(value, f"{da}.value_proj").reshape(
            a.num_cams, -1, heads, e // heads)
        norm = torch.tensor([[w, h] for h, w in a.level_shapes],
                            dtype=torch.float32, device=query.device)
        seen = mask.any(-1)                                   # (cams, nq)
        slots = torch.zeros_like(query)
        for q0 in range(0, nq, self.BLOCK):
            qb = query[:, q0:q0 + self.BLOCK]
            n = qb.shape[1]
            off = self.linear(qb, f"{da}.sampling_offsets").view(
                1, n, heads, L, P, 2)
            att = self.linear(qb, f"{da}.attention_weights").view(
                1, n, heads, L * P).softmax(-1).view(1, n, heads, L, P)
            off = (off / norm[None, None, None, :, None, :]).view(
                1, n, heads, L, P // D, D, 2)
            for c in range(a.num_cams):
                vis = seen[c, q0:q0 + n]
                if not bool(vis.any()):
                    continue
                ref = uv[c, q0:q0 + n][None, :, None, None, None, :, :]
                loc = (ref + off).reshape(1, n, heads, L, P, 2)
                out = msda(v[c:c + 1], a.level_shapes, loc, att)
                slots[:, q0:q0 + n] += out * vis[None, :, None].to(out.dtype)
        count = seen.sum(0).clamp(min=1).to(query.dtype)      # (nq,)
        slots = slots / count[None, :, None]
        return self.linear(slots, f"{pre}.output_proj") + query

    def self_attn(self, query, pos, pre):
        """mmcv ``MultiheadAttention``: q = k = query + pos, v = query."""
        a = self.a
        e, heads = a.embed_dims, a.num_heads
        w = self.w[f"{pre}.attn.in_proj_weight"]
        b = self.w[f"{pre}.attn.in_proj_bias"]
        qk = query + pos

        def split(x, i):
            y = F.linear(x, w[i * e:(i + 1) * e], b[i * e:(i + 1) * e])
            return y.view(x.shape[0], -1, heads, e // heads).transpose(1, 2)

        q, k, v = split(qk, 0), split(qk, 1), split(query, 2)
        s = (q / math.sqrt(e // heads)) @ k.transpose(-1, -2)
        out = (s.softmax(-1) @ v).transpose(1, 2).reshape(query.shape)
        return self.linear(out, f"{pre}.attn.out_proj") + query

    def cross_attn(self, query, pos, value, ref, pre):
        """``CustomMSDeformableAttention`` over the BEV, one level."""
        a = self.a
        nq, e = query.shape[1], a.embed_dims
        heads, P = a.num_heads, a.decoder_num_points
        q = query + pos
        v = self.linear(value, f"{pre}.value_proj").view(1, -1, heads,
                                                         e // heads)
        off = self.linear(q, f"{pre}.sampling_offsets").view(
            1, nq, heads, 1, P, 2)
        att = self.linear(q, f"{pre}.attention_weights").view(
            1, nq, heads, P).softmax(-1).view(1, nq, heads, 1, P)
        norm = torch.tensor([[a.bev_w, a.bev_h]], dtype=torch.float32,
                            device=query.device)
        loc = ref[:, :, None, None, None, :2] + off / norm[None, None, None,
                                                           :, None, :]
        out = msda(v, ((a.bev_h, a.bev_w),), loc, att)
        return self.linear(out, f"{pre}.output_proj") + query

    # -- the BEV ----------------------------------------------------------
    def rotate(self, bev, angle_deg: float):
        """torchvision ``rotate`` of the (C, h, w) grid about its centre
        by ``angle_deg`` counter-clockwise, its affine grid, bilinear (a
        departure: upstream takes the nearest pixel), zero fill."""
        a = self.a
        h, w = a.bev_h, a.bev_w
        img = bev[0].reshape(h, w, -1).permute(2, 0, 1)[None]
        rot = math.radians(-angle_deg)
        # torchvision's inverse affine matrix of rotate(angle), centre 0
        theta = torch.tensor([[math.cos(rot), math.sin(rot), 0.0],
                              [-math.sin(rot), math.cos(rot), 0.0]],
                             dtype=torch.float32, device=bev.device)
        xs = torch.linspace(-w * 0.5 + 0.5, w * 0.5 - 0.5, w,
                            device=bev.device)
        ys = torch.linspace(-h * 0.5 + 0.5, h * 0.5 - 0.5, h,
                            device=bev.device)
        base = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                            torch.ones(h, w, device=bev.device)], -1)
        scale = torch.tensor([0.5 * w, 0.5 * h], device=bev.device)
        grid = (base.reshape(-1, 3) @ (theta.t() / scale)).view(1, h, w, 2)
        out = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)
        return out[0].permute(1, 2, 0).reshape(1, h * w, -1)

    def shift(self, can_bus: np.ndarray) -> torch.Tensor:
        """Upstream's BEV shift of the ego motion, in numpy float64."""
        a = self.a
        dx, dy = can_bus[0], can_bus[1]
        ego_angle = can_bus[-2] / np.pi * 180
        gy = (a.pc_range[4] - a.pc_range[1]) / a.bev_h
        gx = (a.pc_range[3] - a.pc_range[0]) / a.bev_w
        length = np.sqrt(dx ** 2 + dy ** 2)
        angle = np.arctan2(dy, dx) / np.pi * 180
        bev_angle = ego_angle - angle
        sy = length * np.cos(bev_angle / 180 * np.pi) / gy / a.bev_h
        sx = length * np.sin(bev_angle / 180 * np.pi) / gx / a.bev_w
        return torch.tensor([[sx * a.use_shift, sy * a.use_shift]],
                            dtype=torch.float32)

    def bev_features(self, feats, lidar2img, can_bus: np.ndarray,
                     prev_bev=None):
        """``PerceptionTransformer.get_bev_features`` and the encoder:
        ``feats`` one (1, cams, h, w, C) map a level."""
        a, w = self.a, self.w
        dev = lidar2img.device
        bev_q = w[f"{HEAD}.bev_embedding.weight"][None]
        row = w[f"{HEAD}.positional_encoding.row_embed.weight"]
        col = w[f"{HEAD}.positional_encoding.col_embed.weight"]
        pos = torch.cat([col[None].expand(a.bev_h, -1, -1),
                         row[:, None].expand(-1, a.bev_w, -1)],
                        -1).reshape(1, a.bev_num, -1)
        shift = self.shift(can_bus).to(dev)
        if prev_bev is not None and a.rotate_prev_bev:
            prev_bev = self.rotate(prev_bev, float(can_bus[-1]))
        cb = torch.tensor(can_bus, dtype=torch.float32, device=dev)[None]
        if a.use_can_bus:
            y = F.relu(self.linear(cb, f"{TR}.can_bus_mlp.0"))
            y = F.relu(self.linear(y, f"{TR}.can_bus_mlp.2"))
            if a.can_bus_norm:
                y = self.norm(y, f"{TR}.can_bus_mlp.norm")
            bev_q = bev_q + y[:, None]
        vals = []
        for lvl, f in enumerate(feats):
            v = f[0].reshape(a.num_cams, -1, a.embed_dims)
            v = v + w[f"{TR}.cams_embeds"][:, None]
            vals.append(v + w[f"{TR}.level_embeds"][None, lvl:lvl + 1])
        value = torch.cat(vals, 1)                        # (cams, nv, C)
        uv, mask = self.point_sampling(lidar2img)
        ref_2d = self.ref_2d(dev)
        shift_ref = ref_2d + shift[:, None, None, :]
        query, frame_query = bev_q, bev_q
        for i in range(a.encoder_layers):
            pre = f"{TR}.encoder.layers.{i}"
            query = self.norm(self.tsa(query, pos, prev_bev, frame_query,
                                       ref_2d, shift_ref,
                                       f"{pre}.attentions.0"),
                              f"{pre}.norms.0")
            query = self.norm(self.sca(query, value, uv, mask,
                                       f"{pre}.attentions.1"),
                              f"{pre}.norms.1")
            query = self.norm(self.ffn(query, pre), f"{pre}.norms.2")
        return query

    @staticmethod
    def inverse_sigmoid(x, eps=1e-5):
        x = x.clamp(0, 1)
        return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))

    def head(self, bev_embed):
        """The decoder and ``BEVFormerHead``'s class and box branches:
        (cls (L, 1, nq, classes), bbox (L, 1, nq, code))."""
        a, w = self.a, self.w
        qe = w[f"{HEAD}.query_embedding.weight"]
        pos, query = qe[None, :, :a.embed_dims], qe[None, :, a.embed_dims:]
        ref = self.linear(pos, f"{TR}.reference_points").sigmoid()
        cls, box = [], []
        pc = a.pc_range
        for i in range(a.decoder_layers):
            pre = f"{TR}.decoder.layers.{i}"
            q = self.norm(self.self_attn(query, pos, f"{pre}.attentions.0"),
                          f"{pre}.norms.0")
            q = self.norm(self.cross_attn(q, pos, bev_embed, ref,
                                          f"{pre}.attentions.1"),
                          f"{pre}.norms.1")
            query = self.norm(self.ffn(q, pre), f"{pre}.norms.2")
            c = query
            for j in range(2):
                c = F.relu(self.norm(self.linear(
                    c, f"{HEAD}.cls_branches.{i}.{3 * j}"),
                    f"{HEAD}.cls_branches.{i}.{3 * j + 1}"))
            cls.append(self.linear(c, f"{HEAD}.cls_branches.{i}.6"))
            r = query
            for j in range(2):
                r = F.relu(self.linear(r, f"{HEAD}.reg_branches.{i}.{2 * j}"))
            tmp = self.linear(r, f"{HEAD}.reg_branches.{i}.4")
            inv = self.inverse_sigmoid(ref)
            xy = (tmp[..., 0:2] + inv[..., 0:2]).sigmoid()
            z = (tmp[..., 4:5] + inv[..., 2:3]).sigmoid()
            box.append(torch.cat([xy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
                                  xy[..., 1:2] * (pc[4] - pc[1]) + pc[1],
                                  tmp[..., 2:4], z * (pc[5] - pc[2]) + pc[2],
                                  tmp[..., 5:]], -1))
            new = torch.cat([tmp[..., 0:2] + inv[..., 0:2],
                             tmp[..., 4:5] + inv[..., 2:3]], -1)
            ref = new.sigmoid().detach()
        return torch.stack(cls), torch.stack(box)

    def forward(self, feats, lidar2img, can_bus: np.ndarray, prev_bev=None):
        bev = self.bev_features(feats, lidar2img, can_bus, prev_bev)
        cls, box = self.head(bev)
        return {"bev_embed": bev, "all_cls_scores": cls,
                "all_bbox_preds": box}


class Video:
    """Upstream's ``BEVFormer.forward_test`` over :class:`Ref` (batch 1):
    ``prev_frame_info`` kept here."""

    def __init__(self, ref: Ref):
        self.ref = ref
        self.scene = None
        self.prev_bev: Optional[torch.Tensor] = None
        self.prev_pos = None
        self.prev_angle = 0.0

    def frame(self, feats, lidar2img, can_bus: np.ndarray, scene) -> Dict:
        if scene != self.scene:
            self.prev_bev = None
        self.scene = scene
        can_bus = np.array(can_bus, dtype=np.float64)
        pos, angle = can_bus[:3].copy(), float(can_bus[-1])
        if self.prev_bev is not None:
            can_bus[:3] -= self.prev_pos
            can_bus[-1] -= self.prev_angle
        else:
            can_bus[-1] = 0
            can_bus[:3] = 0
        out = self.ref.forward(feats, lidar2img, can_bus, self.prev_bev)
        self.prev_pos, self.prev_angle = pos, angle
        self.prev_bev = out["bev_embed"]
        return out
