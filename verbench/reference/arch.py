"""The architecture a configuration file describes, and its weights.

``Arch`` reads the ``model`` and ``reference`` groups of a file under
``verbench/configs/`` and derives the sizes the reference and the FLOP
formulas need.  ``param_specs`` lists every parameter of the VoxelFormer
under its published ``state_dict`` name (DefaultRui/VLN-VER,
``projects/mmdet3d_plugin``: ``pts_bbox_head.*``) with its shape and how
it is drawn; ``make_weights`` draws them all on one device from a seed,
in one call of the generator.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


class Arch:
    """Sizes of one configuration (the file's ``model`` group holds the
    program's configuration fields as they are run)."""

    def __init__(self, spec: Dict):
        self.spec = spec
        m = spec["model"]
        self.m = m
        ref = spec.get("reference", {})
        self.ln_eps = float(ref.get("layer_norm_eps", 1e-6))
        self.image_wh = tuple(ref.get("image_wh", (1280.0, 1024.0)))
        for key in ("bev_z", "bev_h", "bev_w", "num_cams", "feat_h",
                    "feat_w", "in_channels", "embed_dims", "num_heads",
                    "encoder_layers", "sca_num_points", "decoder_layers",
                    "decoder_num_points", "num_levels", "ffn_dim",
                    "num_query", "num_layout_query", "num_classes",
                    "occupancy_classes", "code_size", "num_reg_fcs",
                    "num_occ_fcs", "occ_dims", "sca_query_capacity"):
            setattr(self, key, int(m[key]))
        self.pc_range = tuple(float(v) for v in m["pc_range"])
        self.occupancy_size = tuple(float(v) for v in m["occupancy_size"])
        self.dropout_rate = float(m["dropout_rate"])
        self.dtype = m["dtype"]
        if not m["refine_occ"]:
            raise ValueError("the reference covers refine_occ=True")
        for flag in ("only_occ", "only_det", "add_layout",
                     "use_temporal_self_attn", "decoder_on_bev"):
            if m[flag]:
                raise ValueError(f"the reference does not cover {flag}")
        if m["occ_layout"] not in ("zhwc", "zhwc_dense"):
            raise ValueError("the reference covers the zhwc layouts")
        if m["occ_loss_type"] != "focal_loss":
            raise ValueError("the reference covers the focal occupancy loss")
        if self.num_levels != 1:
            raise ValueError("the reference covers one feature level")

    @property
    def head_dim(self) -> int:
        return self.embed_dims // self.num_heads

    @property
    def bev_num(self) -> int:
        return self.bev_z * self.bev_h * self.bev_w

    def _occ(self, axis: int) -> int:
        return round((self.pc_range[axis + 3] - self.pc_range[axis])
                     / self.occupancy_size[axis])

    @property
    def occ_zdim(self) -> int:
        return self._occ(2)

    @property
    def occ_ydim(self) -> int:
        return self._occ(1)

    @property
    def occ_xdim(self) -> int:
        return self._occ(0)

    @property
    def voxel_num(self) -> int:
        return self.occ_zdim * self.occ_ydim * self.occ_xdim

    @property
    def up_stages(self) -> int:
        return int(round(math.log2(self.occ_xdim // self.bev_w)))

    @property
    def lift_queries(self) -> int:
        """Query slots a camera's lift attends from: the capacity of the
        sparse lift, every voxel query in the dense one."""
        cap = self.sca_query_capacity
        return cap if 0 < cap < self.bev_num else self.bev_num


def _grid_bias(heads: int, points: int, dims: int) -> torch.Tensor:
    """The directional offset bias of the published init
    (spatial_cross_attention.py:255-269, voxel_decoder.py:212-226): head
    h points along (cos, sin[, cos + sin]) of 2 pi h / heads, normalised
    by its largest component, scaled by 1..points."""
    th = torch.arange(heads, dtype=torch.float64) * (2.0 * math.pi / heads)
    comps = [th.cos(), th.sin()] + ([th.cos() + th.sin()] if dims == 3
                                    else [])
    g = torch.stack(comps, dim=-1)
    g = g / g.abs().max(dim=-1, keepdim=True).values
    scale = torch.arange(1, points + 1, dtype=torch.float64)
    return (g[:, None, :] * scale[None, :, None]).reshape(-1).float()


Spec = Tuple[str, Tuple[int, ...], str]


def param_specs(a: Arch) -> List[Spec]:
    """(name, shape, kind) of every parameter, in a fixed order."""
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

    hd = "pts_bbox_head"
    tr = f"{hd}.transformer"
    out.append((f"{hd}.voxel_embedding.weight", (a.bev_num, e), "table"))
    for axis, n in (("row", a.bev_h), ("col", a.bev_w), ("z", a.bev_z)):
        out.append((f"{hd}.positional_encoding.{axis}_embed.weight", (n, e),
                    "table"))
    out.append((f"{tr}.cams_embeds", (a.num_cams, e), "table"))
    out.append((f"{tr}.level_embeds", (a.num_levels, e), "table"))
    for i in range(a.encoder_layers):
        pre = f"{tr}.encoder.layers.{i}"
        da = f"{pre}.attentions.0.deformable_attention"
        lin(f"{da}.value_proj", e, e)
        lin(f"{da}.sampling_offsets", h * a.sca_num_points * 2, e,
            "offset", "offset_bias_2d")
        lin(f"{da}.attention_weights", h * a.sca_num_points, e)
        lin(f"{pre}.attentions.0.output_proj", e, e)
        norm(f"{pre}.norms.0", e)
        norm(f"{pre}.norms.1", e)
        ffn(pre)
    for i in range(a.decoder_layers):
        pre = f"{tr}.decoder.layers.{i}"
        out.append((f"{pre}.attentions.0.attn.in_proj_weight", (3 * e, e),
                    "linear"))
        out.append((f"{pre}.attentions.0.attn.in_proj_bias", (3 * e,),
                    "bias"))
        lin(f"{pre}.attentions.0.attn.out_proj", e, e)
        ca = f"{pre}.attentions.1"
        lin(f"{ca}.value_proj", e, e)
        lin(f"{ca}.sampling_offsets", h * a.decoder_num_points * 3, e,
            "offset", "offset_bias_3d")
        lin(f"{ca}.attention_weights", h * a.decoder_num_points, e)
        lin(f"{ca}.output_proj", e, e)
        for j in range(3):
            norm(f"{pre}.norms.{j}", e)
        ffn(pre)
    lin(f"{tr}.reference_points", 3, e)
    out.append((f"{hd}.query_embedding.weight", (a.num_query, 2 * e),
                "table"))
    out.append((f"{hd}.query_layout_embedding.weight",
                (a.num_layout_query, 2 * e), "table"))
    for i in range(a.decoder_layers):
        pre = f"{hd}.cls_branches.{i}"
        for j in range(a.num_reg_fcs):
            lin(f"{pre}.{3 * j}", e, e)
            norm(f"{pre}.{3 * j + 1}", e)
        lin(f"{pre}.{3 * a.num_reg_fcs}", a.num_classes, e, "linear",
            "cls_prior")
    for i in range(a.decoder_layers):
        pre = f"{hd}.reg_branches.{i}"
        for j in range(a.num_reg_fcs):
            lin(f"{pre}.{2 * j}", e, e)
        lin(f"{pre}.{2 * a.num_reg_fcs}", a.code_size, e)
    if a.bev_z == a.occ_zdim:
        lin(f"{hd}.occ_proj", a.occ_dims, e)
    else:
        lin(f"{hd}.occ_proj", a.occ_dims * a.occ_zdim, a.bev_z * e)
    od = a.occ_dims
    for j in range(a.num_occ_fcs):
        lin(f"{hd}.occ_branches.{3 * j}", od, od)
        norm(f"{hd}.occ_branches.{3 * j + 1}", od)
    lin(f"{hd}.occ_branches.{3 * a.num_occ_fcs}", a.occupancy_classes, od,
        "linear", "cls_prior")
    for i in range(a.up_stages):
        out.append((f"{hd}.up_sample.{i}.weight", (e, e, 3, 5, 5),
                    "upsample"))
        out.append((f"{hd}.up_sample.{i}.bias", (e,), "bias"))
    return out


# spread of each kind: a multiple of 1 / sqrt(fan-in) for kernels
_KERNEL_GAIN = {"linear": 1.0, "offset": 0.5, "upsample": 1.0}


def make_weights(a: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
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
    out, off = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if kind in _KERNEL_GAIN:
            fan_in = n // shape[0] if kind != "upsample" else n // shape[1]
            t.mul_(_KERNEL_GAIN[kind] / math.sqrt(fan_in))
        elif kind == "bias":
            t.mul_(0.02)
        elif kind == "ln_weight":
            t.mul_(0.1).add_(1.0)
        elif kind == "offset_bias_2d":
            t.copy_(_grid_bias(a.num_heads, a.sca_num_points, 2))
        elif kind == "offset_bias_3d":
            t.copy_(_grid_bias(a.num_heads, a.decoder_num_points, 3))
        elif kind == "cls_prior":
            # the focal prior of the published init, bias_init_with_prob(0.01)
            t.fill_(-math.log(99.0))
        elif kind != "table":
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = t
    return out


def _stream(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose of one run: weights, pool, order."""
    import numpy as np
    return int(np.random.SeedSequence([int(seed), purpose]).generate_state(
        2, dtype=np.uint64)[0] >> np.uint64(1))
