"""TPVFormer's occupancy model (``tpv04_occupancy``): the architecture a
configuration file describes, its weights by upstream's names, and its
plain reference forward in fp32.

Written from wzzheng/TPVFormer (``config/tpv04_occupancy.py``;
``tpvformer04``: ``TPVFormerHead``, ``CustomPositionalEncoding``,
``TPVFormerEncoder`` with ``get_reference_points``, ``point_sampling`` and
``get_cross_view_ref_points``, ``TPVFormerLayer``,
``TPVCrossViewHybridAttention``, ``TPVImageCrossAttention`` with
``TPVMSDeformableAttention3D``, ``TPVAggregator``) with library calls
only: ``F.linear``, ``F.layer_norm``, ``F.softplus``, ``F.interpolate`` and
``F.grid_sample`` for every bilinear tap (``reference/bevformer.py``'s
``msda``, upstream's ``multi_scale_deformable_attn_pytorch``).  Nothing
here imports the program.

* The image cross-attention is dense and masked, in the direct form: each
  plane's query attends with all its points at once, every point at its
  own pillar anchor, into every camera; a camera that sees none of the
  query's anchors adds nothing, and the sum is divided by the number of
  cameras that do.  Upstream cuts a side plane's query into groups of
  anchors (``points_multiplier``), rebatches the visible ones a camera
  and sums the groups' outputs: the same sum, since the weights are
  softmaxed over all the query's points before the cut.
* Dropout is the identity (inference).

Departures from upstream, each also in the configuration's
``departures``: the image backbone (ResNet-101 with DCNv2) and the FPN
are cut, the forward starts at the neck's four maps per camera; the
lidar-to-image matrices are normalised by the padded image (1600, 928),
as upstream's ``img_shape``, with pixel coordinates beyond the depth clamp
clipped to [-1, 2] (upstream divides by 1e-5): both lie outside every
map, so no tap moves; weights are random from the seed.

``Ref(a, w)`` runs over a dict of weights by upstream's names
(:func:`make_weights`, ``tpv_head.*`` and ``tpv_aggregator.*``).  The
control (TF32) is the same code with TF32 on.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .arch import _stream
from .bevformer import msda

HEAD = "tpv_head"
ENC = f"{HEAD}.encoder"
AGG = "tpv_aggregator"
Weights = Dict[str, torch.Tensor]


class Arch:
    """Sizes of one TPVFormer configuration (the file's ``model`` group
    holds the program's ``TPVConfig`` fields as they are run)."""

    def __init__(self, spec: Dict):
        self.spec = spec
        m = spec["model"]
        self.m = m
        for key in ("tpv_h", "tpv_w", "tpv_z", "embed_dims", "num_heads",
                    "ffn_dim", "num_levels", "num_cams", "encoder_layers",
                    "cross_layers", "hybrid_anchors", "hybrid_points",
                    "scale_h", "scale_w", "scale_z", "num_classes",
                    "hidden_dims", "ica_query_capacity"):
            setattr(self, key, int(m[key]))
        self.pos_dims = tuple(int(v) for v in m["pos_dims"])
        self.num_points_in_pillar = tuple(
            int(v) for v in m["num_points_in_pillar"])
        self.num_points = tuple(int(v) for v in m["num_points"])
        self.level_shapes: Tuple[Tuple[int, int], ...] = tuple(
            (int(h), int(w)) for h, w in m["feat_shapes"])
        self.pc_range = tuple(float(v) for v in m["pc_range"])
        self.image_wh = tuple(float(v) for v in m["image_wh"])
        self.ln_eps = float(m["layer_norm_eps"])
        self.dtype = m["dtype"]
        if len(self.level_shapes) != self.num_levels:
            raise ValueError("feat_shapes must give num_levels levels")
        if self.dtype != "float32":
            raise ValueError("the reference covers the fp32 model")

    @property
    def head_dim(self) -> int:
        return self.embed_dims // self.num_heads

    @property
    def plane_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """(rows, columns) of the HW, ZH and WZ planes."""
        return ((self.tpv_h, self.tpv_w), (self.tpv_z, self.tpv_h),
                (self.tpv_w, self.tpv_z))

    @property
    def plane_lens(self) -> Tuple[int, int, int]:
        return tuple(h * w for h, w in self.plane_shapes)

    @property
    def queries(self) -> int:
        return sum(self.plane_lens)

    @property
    def value_rows(self) -> int:
        """A camera's value rows, every level's h * w."""
        return sum(h * w for h, w in self.level_shapes)

    @property
    def groups(self) -> Tuple[int, ...]:
        """Upstream's ``points_multiplier`` of each plane."""
        return tuple(a // self.num_points_in_pillar[0]
                     for a in self.num_points_in_pillar)

    @property
    def lift_queries(self) -> int:
        """Sub-query slots a camera's lift attends from."""
        slots = sum(n * g for n, g in zip(self.plane_lens, self.groups))
        cap = self.ica_query_capacity
        return cap if 0 < cap < slots else slots

    @property
    def lattice(self) -> Tuple[int, int, int]:
        """(W, H, Z) of the logits."""
        return (self.tpv_w * self.scale_w, self.tpv_h * self.scale_h,
                self.tpv_z * self.scale_z)


Spec = Tuple[str, Tuple[int, ...], str]


def param_specs(a: Arch) -> List[Spec]:
    """(name, shape, kind) of every parameter, by upstream's names, in a
    fixed order."""
    e, h, L = a.embed_dims, a.num_heads, a.num_levels
    P = a.hybrid_points
    out: List[Spec] = []

    def lin(name, n_out, n_in, wkind="linear", bkind="bias"):
        out.append((f"{name}.weight", (n_out, n_in), wkind))
        out.append((f"{name}.bias", (n_out,), bkind))

    out.append((f"{HEAD}.level_embeds", (L, e), "table"))
    out.append((f"{HEAD}.cams_embeds", (a.num_cams, e), "table"))
    for plane, n in zip(("hw", "zh", "wz"), a.plane_lens):
        out.append((f"{HEAD}.tpv_embedding_{plane}.weight", (n, e), "table"))
    for axis, n, f in zip("hwz", (a.tpv_h, a.tpv_w, a.tpv_z), a.pos_dims):
        out.append((f"{HEAD}.positional_encoding.{axis}_embed.weight",
                    (n, f), "table"))
    for i in range(a.encoder_layers):
        pre = f"{ENC}.layers.{i}"
        cv = f"{pre}.attentions.0"
        for j in range(3):
            lin(f"{cv}.sampling_offsets.{j}", h * 3 * P * 2, e, "offset",
                "offset_bias_hybrid")
            lin(f"{cv}.attention_weights.{j}", h * 3 * (P + 1), e)
            lin(f"{cv}.value_proj.{j}", e, e)
            lin(f"{cv}.output_proj.{j}", e, e)
        norms = 2
        if i < a.cross_layers:
            norms = 3
            da = f"{pre}.attentions.1.deformable_attention"
            for j, p in enumerate(a.num_points):
                lin(f"{da}.sampling_offsets.{j}", h * L * p * 2, e, "offset",
                    f"offset_bias_ica{j}")
                lin(f"{da}.attention_weights.{j}", h * L * p, e)
            lin(f"{da}.value_proj", e, e)
            lin(f"{pre}.attentions.1.output_proj", e, e)
        for j in range(norms):
            out.append((f"{pre}.norms.{j}.weight", (e,), "ln_weight"))
            out.append((f"{pre}.norms.{j}.bias", (e,), "bias"))
        lin(f"{pre}.ffns.0.layers.0.0", a.ffn_dim, e)
        lin(f"{pre}.ffns.0.layers.1", e, a.ffn_dim)
    lin(f"{AGG}.decoder.0", a.hidden_dims, e)
    lin(f"{AGG}.decoder.2", e, a.hidden_dims)
    lin(f"{AGG}.classifier", a.num_classes, e)
    return out


_KERNEL_GAIN = {"linear": 1.0, "offset": 0.5}


def _directions(heads: int) -> torch.Tensor:
    """Head h's direction (cos, sin) of 2 pi h / heads, normalised by its
    largest component (the published offsets' init)."""
    th = torch.arange(heads, dtype=torch.float64) * (2.0 * math.pi / heads)
    g = torch.stack([th.cos(), th.sin()], -1)
    return g / g.abs().max(-1, keepdim=True).values


def _offset_bias(heads: int, levels: int, anchors: int,
                 per_anchor: int) -> torch.Tensor:
    """Each head's direction scaled by 1..per_anchor, laid out (heads,
    levels, anchors, per_anchor, 2) (``TPVMSDeformableAttention3D``'s
    init; the hybrid attention's offsets take the same form)."""
    scale = torch.arange(1, per_anchor + 1, dtype=torch.float64)
    g = _directions(heads)[:, None, None, None, :] \
        * scale[None, None, None, :, None]
    return g.expand(heads, levels, anchors, per_anchor, 2).reshape(
        -1).float()


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
    h, L = a.num_heads, a.num_levels
    A = a.hybrid_anchors
    biases = {"offset_bias_hybrid": _offset_bias(
        h, 3, A, a.hybrid_points // A)}
    for j, (anc, p) in enumerate(zip(a.num_points_in_pillar, a.num_points)):
        biases[f"offset_bias_ica{j}"] = _offset_bias(h, L, anc, p // anc)
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
        elif kind != "table":
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = t
    return out


def get_reference_points(H, W, Z, D, device):
    """Upstream's ``get_reference_points(H, W, Z, D, '3d')`` at batch 1:
    (1, D, H*W, 3) normalised (x, y, z), x over W, y over H, z the
    pillar."""
    zs = torch.linspace(0.5, Z - 0.5, D, device=device).view(-1, 1, 1) \
        .expand(D, H, W) / Z
    xs = torch.linspace(0.5, W - 0.5, W, device=device).view(1, 1, -1) \
        .expand(D, H, W) / W
    ys = torch.linspace(0.5, H - 0.5, H, device=device).view(1, -1, 1) \
        .expand(D, H, W) / H
    ref = torch.stack((xs, ys, zs), -1)
    return ref.permute(0, 3, 1, 2).flatten(2).permute(0, 2, 1)[None]


def get_cross_view_ref_points(tpv_h, tpv_w, tpv_z, num_points, device):
    """Upstream's ``get_cross_view_ref_points``: (hw + zh + wz, 3, #p, 2)
    with ``num_points`` points in every pillar."""
    p = num_points

    def lin(n, k):
        return torch.linspace(0.5, n - 0.5, k, device=device) / n

    # hw
    h_r = lin(tpv_h, tpv_h).unsqueeze(-1).expand(-1, tpv_w).flatten()
    w_r = lin(tpv_w, tpv_w).unsqueeze(0).expand(tpv_h, -1).flatten()
    hw_hw = torch.stack([w_r, h_r], -1).unsqueeze(1).expand(-1, p, -1)
    z_r = lin(tpv_z, p).unsqueeze(0).expand(tpv_h * tpv_w, -1)
    h_r = lin(tpv_h, tpv_h).reshape(-1, 1, 1).expand(-1, tpv_w, p) \
        .flatten(0, 1)
    hw_zh = torch.stack([h_r, z_r], -1)
    w_r = lin(tpv_w, tpv_w).reshape(1, -1, 1).expand(tpv_h, -1, p) \
        .flatten(0, 1)
    hw_wz = torch.stack([z_r, w_r], -1)
    # zh
    w_r = lin(tpv_w, p).unsqueeze(0).expand(tpv_z * tpv_h, -1)
    h_r = lin(tpv_h, tpv_h).reshape(1, -1, 1).expand(tpv_z, -1, p) \
        .flatten(0, 1)
    zh_hw = torch.stack([w_r, h_r], -1)
    z_r = lin(tpv_z, tpv_z).reshape(-1, 1, 1).expand(-1, tpv_h, p) \
        .flatten(0, 1)
    zh_zh = torch.stack([h_r, z_r], -1)
    zh_wz = torch.stack([z_r, w_r], -1)
    # wz
    h_r = lin(tpv_h, p).unsqueeze(0).expand(tpv_w * tpv_z, -1)
    w_r = lin(tpv_w, tpv_w).reshape(-1, 1, 1).expand(-1, tpv_z, p) \
        .flatten(0, 1)
    wz_hw = torch.stack([w_r, h_r], -1)
    z_r = lin(tpv_z, tpv_z).reshape(1, -1, 1).expand(tpv_w, -1, p) \
        .flatten(0, 1)
    wz_zh = torch.stack([h_r, z_r], -1)
    wz_wz = torch.stack([z_r, w_r], -1)
    return torch.cat([torch.stack([hw_hw, hw_zh, hw_wz], 1),
                      torch.stack([zh_hw, zh_zh, zh_wz], 1),
                      torch.stack([wz_hw, wz_zh, wz_wz], 1)], 0)


class Ref:
    """The reference forward over weights ``w`` of architecture ``a``
    (batch 1)."""

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

    # -- queries and positions ---------------------------------------------
    def positions(self, device) -> List[torch.Tensor]:
        """Upstream's ``CustomPositionalEncoding`` for the three planes
        (ignore_axis z, w, h): (1, n, C) each."""
        a = self.a
        pe = f"{HEAD}.positional_encoding"
        he, we, ze = (self.w[f"{pe}.{k}_embed.weight"] for k in "hwz")
        H, W, Z = a.tpv_h, a.tpv_w, a.tpv_z
        fh, fw, fz = a.pos_dims
        zero = torch.zeros((), device=device)
        hw = torch.cat((he.reshape(H, 1, -1).repeat(1, W, 1),
                        we.reshape(1, W, -1).repeat(H, 1, 1),
                        zero.repeat(H, W, fz)), -1)
        zh = torch.cat((he.reshape(1, H, -1).repeat(Z, 1, 1),
                        zero.repeat(Z, H, fw),
                        ze.reshape(Z, 1, -1).repeat(1, H, 1)), -1)
        wz = torch.cat((zero.repeat(W, Z, fh),
                        we.reshape(W, 1, -1).repeat(1, Z, 1),
                        ze.reshape(1, Z, -1).repeat(W, 1, 1)), -1)
        return [p.flatten(0, 1)[None] for p in (hw, zh, wz)]

    # -- geometry ----------------------------------------------------------
    def ref_3d(self, device) -> List[torch.Tensor]:
        """The planes' pillars, (1, D, n, 3) normalised (x, y, z) each, with
        upstream's axis permutations."""
        a, pc = self.a, self.a.pc_range
        d_hw, d_zh, d_wz = a.num_points_in_pillar
        hw = get_reference_points(a.tpv_h, a.tpv_w, pc[5] - pc[2], d_hw,
                                  device)
        zh = get_reference_points(a.tpv_z, a.tpv_h, pc[3] - pc[0], d_zh,
                                  device)
        zh = zh.permute(3, 0, 1, 2)[[2, 0, 1]].permute(1, 2, 3, 0)
        wz = get_reference_points(a.tpv_w, a.tpv_z, pc[4] - pc[1], d_wz,
                                  device)
        wz = wz.permute(3, 0, 1, 2)[[1, 2, 0]].permute(1, 2, 3, 0)
        return [hw, zh, wz]

    def point_sampling(self, ref_3d, lidar2img):
        """Upstream's ``point_sampling`` (batch 1): (cams, n, D, 2)
        normalised image coordinates and (cams, n, D) visibility."""
        a, pc = self.a, self.a.pc_range
        r = ref_3d[0].clone()                                 # (D, n, 3)
        r[..., 0] = r[..., 0] * (pc[3] - pc[0]) + pc[0]
        r[..., 1] = r[..., 1] * (pc[4] - pc[1]) + pc[1]
        r[..., 2] = r[..., 2] * (pc[5] - pc[2]) + pc[2]
        r = torch.cat((r, torch.ones_like(r[..., :1])), -1)
        cam = torch.einsum("cij,dqj->cqdi", lidar2img[0].float(), r)
        eps = 1e-5
        mask = cam[..., 2] > eps
        uv = cam[..., 0:2] / torch.maximum(
            cam[..., 2:3], torch.ones_like(cam[..., 2:3]) * eps)
        uv = uv / torch.tensor(a.image_wh, device=uv.device)
        mask = (mask & (uv[..., 1] > 0.0) & (uv[..., 1] < 1.0)
                & (uv[..., 0] < 1.0) & (uv[..., 0] > 0.0))
        uv = torch.clamp(torch.nan_to_num(uv), -1.0, 2.0)
        return uv, mask

    # -- attentions --------------------------------------------------------
    def hybrid(self, queries, pos, ref, pre):
        """``TPVCrossViewHybridAttention``: lists of (1, n, C) in, out."""
        a = self.a
        e, heads, P, A = (a.embed_dims, a.num_heads, a.hybrid_points,
                          a.hybrid_anchors)
        q = [x + p for x, p in zip(queries, pos)]
        value = torch.cat([self.linear(x, f"{pre}.value_proj.{i}")
                           for i, x in enumerate(q)], 1)
        value = value.view(1, -1, heads, e // heads)
        offs, atts = [], []
        for i, x in enumerate(q):
            n = x.shape[1]
            offs.append(self.linear(x, f"{pre}.sampling_offsets.{i}").view(
                1, n, heads, 3, P, 2))
            att = self.linear(x, f"{pre}.attention_weights.{i}").view(
                1, n, heads, 3, P + 1)
            level = att[..., -1:].softmax(-2)
            atts.append(att[..., :-1].softmax(-1) * level)
        off, att = torch.cat(offs, 1), torch.cat(atts, 1)
        shapes = a.plane_shapes
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=value.device)
        n = off.shape[1]
        off = (off / norm[None, None, None, :, None, :]).view(
            1, n, heads, 3, A, P // A, 2)
        loc = ref[None, :, None, :, :, None, :] + off
        out = msda(value, shapes, loc.view(1, n, heads, 3, P, 2), att)
        outs = out.split(list(a.plane_lens), 1)
        return [x + self.linear(o, f"{pre}.output_proj.{i}")
                for i, (x, o) in enumerate(zip(queries, outs))]

    def ica(self, query, value, uvs, masks, pre):
        """``TPVImageCrossAttention`` (batch 1), dense and masked, each
        plane's query with all its points at once."""
        a = self.a
        e, heads, L = a.embed_dims, a.num_heads, a.num_levels
        da = f"{pre}.deformable_attention"
        v = self.linear(value, f"{da}.value_proj").view(
            a.num_cams, -1, heads, e // heads)
        norm = torch.tensor([[w, h] for h, w in a.level_shapes],
                            dtype=torch.float32, device=query.device)
        outs = []
        for i, q in enumerate(query.split(list(a.plane_lens), 1)):
            n = q.shape[1]
            D, P = a.num_points_in_pillar[i], a.num_points[i]
            g = a.groups[i]
            a0 = D // g
            off = self.linear(q, f"{da}.sampling_offsets.{i}").view(
                1, n, heads, L, g, P // D, a0, 2)
            off = off / norm[None, None, None, :, None, None, None, :]
            att = self.linear(q, f"{da}.attention_weights.{i}").view(
                1, n, heads, L * P).softmax(-1).view(1, n, heads, L, P)
            seen = masks[i].any(-1)                           # (cams, n)
            slot = torch.zeros((1, n, e), device=q.device)
            for c in range(a.num_cams):
                if not bool(seen[c].any()):
                    continue
                # point (group, j, anchor) of a level samples at anchor
                # group * a0 + anchor of the pillar
                ref = uvs[i][c].view(1, n, 1, 1, g, 1, a0, 2)
                loc = (ref + off).reshape(1, n, heads, L, P, 2)
                out = msda(v[c:c + 1], a.level_shapes, loc, att)
                slot += out * seen[c][None, :, None].to(out.dtype)
            count = seen.sum(0).clamp(min=1).to(q.dtype)
            outs.append(slot / count[None, :, None])
        slots = torch.cat(outs, 1)
        return self.linear(slots, f"{pre}.output_proj") + query

    def aggregate(self, hw, zh, wz):
        """``TPVAggregator`` without points: (1, classes, W, H, Z)."""
        a = self.a
        H, W, Z = a.tpv_h, a.tpv_w, a.tpv_z
        c = hw.shape[-1]
        hw = hw.permute(0, 2, 1).reshape(1, c, H, W)
        zh = zh.permute(0, 2, 1).reshape(1, c, Z, H)
        wz = wz.permute(0, 2, 1).reshape(1, c, W, Z)
        sh, sw, sz = a.scale_h, a.scale_w, a.scale_z
        hw = F.interpolate(hw, size=(H * sh, W * sw), mode="bilinear")
        zh = F.interpolate(zh, size=(Z * sz, H * sh), mode="bilinear")
        wz = F.interpolate(wz, size=(W * sw, Z * sz), mode="bilinear")
        hw = hw.unsqueeze(-1).permute(0, 1, 3, 2, 4).expand(
            -1, -1, -1, -1, sz * Z)
        zh = zh.unsqueeze(-1).permute(0, 1, 4, 3, 2).expand(
            -1, -1, sw * W, -1, -1)
        wz = wz.unsqueeze(-1).permute(0, 1, 2, 4, 3).expand(
            -1, -1, -1, sh * H, -1)
        fused = (hw + zh + wz).permute(0, 2, 3, 4, 1)
        x = F.softplus(self.linear(fused, f"{AGG}.decoder.0"))
        x = self.linear(x, f"{AGG}.decoder.2")
        return self.linear(x, f"{AGG}.classifier").permute(0, 4, 1, 2, 3)

    # -- the frame ---------------------------------------------------------
    def forward(self, feats, lidar2img) -> Dict[str, torch.Tensor]:
        """``feats``: one (1, cams, h, w, C) map a level; ``lidar2img``
        (1, cams, 4, 4).  Returns the three planes and the logits."""
        a, w = self.a, self.w
        dev = lidar2img.device
        queries = [w[f"{HEAD}.tpv_embedding_{p}.weight"][None]
                   for p in ("hw", "zh", "wz")]
        pos = self.positions(dev)
        vals = []
        for lvl, f in enumerate(feats):
            v = f[0].reshape(a.num_cams, -1, a.embed_dims)
            v = v + w[f"{HEAD}.cams_embeds"][:, None]
            vals.append(v + w[f"{HEAD}.level_embeds"][None, lvl:lvl + 1])
        value = torch.cat(vals, 1)                        # (cams, nv, C)
        sampled = [self.point_sampling(r, lidar2img)
                   for r in self.ref_3d(dev)]
        uvs = [s[0] for s in sampled]
        masks = [s[1] for s in sampled]
        ref = get_cross_view_ref_points(a.tpv_h, a.tpv_w, a.tpv_z,
                                        a.hybrid_anchors, dev)
        lens = list(a.plane_lens)
        for i in range(a.encoder_layers):
            pre = f"{ENC}.layers.{i}"
            queries = self.hybrid(queries, pos, ref, f"{pre}.attentions.0")
            query = self.norm(torch.cat(queries, 1), f"{pre}.norms.0")
            last = 1
            if i < a.cross_layers:
                query = self.norm(self.ica(query, value, uvs, masks,
                                           f"{pre}.attentions.1"),
                                  f"{pre}.norms.1")
                last = 2
            query = self.norm(self.ffn(query, pre), f"{pre}.norms.{last}")
            queries = list(query.split(lens, 1))
        hw, zh, wz = queries
        return {"tpv_hw": hw, "tpv_zh": zh, "tpv_wz": wz,
                "logits": self.aggregate(hw, zh, wz)}
