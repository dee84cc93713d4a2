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

With ``refine_occ`` the voxel grid goes through ``up_sample``
(:class:`OccUpsampler`), the reference's stack of transposed convolutions
that each double (h, w) (reference names ``up_sample.{i}``), computed by
the JAX package's even-grid factorisation.  With autograd off on the card
each stage's convolutions run on z-major activations and one kernel
assembles the stage's even grid from their outputs (``ops/up_assemble.py``,
``csrc/up_assemble.cu``).  ``occ_layout`` picks how the upsampled volume
reaches ``occ_proj``:

* ``'zhwc'`` (default): the (Z, H, W, C) layout.  Every odd row or column
  of a stride-2, dilation-2 transposed convolution is its bias alone, so
  the full volume is never built: ``occ_proj`` and the occupancy MLP run
  on the even (y, x) cells (``OccUpsampler.informative``) plus one bias
  cell and the logits are interleaved: the same function as
  ``'zhwc_dense'`` with a quarter of the projection work.  In bf16
  inference on the card the MLP and the interleave are one kernel
  (``ops/occ_mlp.py``, ``csrc/occ_mlp.cu``);
* ``'zhwc_dense'``: every cell projected;
* ``'ref'``: the reference's raw ``.view`` reinterpretations (head:558,
  564), so that weights converted from a reference checkpoint give the
  reference's occupancy.

Occupancy flat order: ``z * (ydim * xdim) + y * xdim + x``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import up_assemble
from ..ops.occ_mlp import (fused_route, lattice_plain, occ_mlp_lattice,
                           occ_mlp_rows)
from ..ops.up_assemble import Taps
from ..utils.cuda_graph import GraphCache
from ..utils.profiling import count, span
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


def _zslab(x: torch.Tensor, kernel: torch.Tensor, pad_y, pad_x):
    """One z-tap of the kernel over a slab of planes, no padding in z:
    x (B, z, H, W, I), kernel (O, I, kh, kw) -> (B, z, H', W', O), a 2D
    correlation of every plane, run channels-last as a 3D convolution of
    depth 1: cuDNN's 2D form of the stage-1 5 x 5 correlation at a few
    planes takes a weight-gradient algorithm about 5e-4 off a float64 run
    in relative L2 in fp32 on an H100, the 3D form about 1e-6
    (chip_smoke.py phase 5b)."""
    if pad_y[0] != pad_y[1] or pad_x[0] != pad_x[1]:
        x = F.pad(x, (0, 0, *pad_x, *pad_y))
        pad = (0, 0, 0)
    else:
        pad = (0, pad_y[0], pad_x[0])
    return F.conv3d(x.permute(0, 4, 1, 2, 3), kernel[:, :, None],
                    padding=pad).permute(0, 2, 3, 4, 1)


def _plane_conv(x: torch.Tensor, kernel: torch.Tensor, pad) -> torch.Tensor:
    """z-major x (n, B, H, W, I), kernel (O, I, kh, kw) -> (n, B, H', W', O):
    every plane's 2D correlation with the symmetric padding ``pad`` (y, x),
    a depth-1 3D convolution over the n B planes as images (the 3D form,
    as :func:`_zslab`).  A view of the convolution's output, never copied:
    channels-last where cuDNN writes it so."""
    n, b, h, w, c = x.shape
    y = F.conv3d(x.reshape(n * b, 1, h, w, c).permute(0, 4, 1, 2, 3),
                 kernel[:, :, None], padding=(0, *pad))
    return y.permute(0, 2, 3, 4, 1).reshape(n, b, *y.shape[3:], y.shape[1])


def _ztaps(x: torch.Tensor, kernel: torch.Tensor, pad,
           planes: int = 0) -> Taps:
    """z-major x (Z, B, H, W, I), kernel (O, I, 3, kh, kw) -> the z-taps'
    outputs, as :meth:`_UpStage._conv` pairs them (k = 1 on every plane,
    k = 0 on planes :Z-2, k = 2 on planes 2:), each a contiguous leading
    slice of ``x``.  With ``planes``, x is one plane standing for each of
    that many equal planes (the bias profile's range mask), and each tap
    runs on it once."""
    z = planes or x.shape[0]
    mid = _plane_conv(x, kernel[:, :, 1], pad)
    if z <= 2:
        return Taps(mid, None, None)
    low, high = (x, x) if planes else (x[:z - 2], x[2:])
    return Taps(mid, _plane_conv(low, kernel[:, :, 0], pad),
                _plane_conv(high, kernel[:, :, 2], pad))


class _UpStage(ConvTranspose3d):
    """One upsampler stage by the JAX package's even-grid factorisation
    (vln_ver_tpu/models/head.py:94-207), on NDHWC tensors.

    The parameters, their initialisation and the function are the
    reference stage's (:class:`ConvTranspose3d`, torch's ``(in, out, 3, 5,
    5)`` weight).  With stride 2 and dilation 2 every tap lands on an even
    output (y, x), so the stage is a stride-1 correlation on the even grid
    with the flipped kernel, and each odd row or column is the bias alone.
    For stages >= 2 the input has that structure too, so ``phase_conv``
    splits the correlation into four parity-phase convolutions over the
    input's even grid plus a batch-free bias profile.  The correlation
    kernel is derived from ``weight`` at every call, never cached: tensor
    parallelism swaps the parameter's ``.data``.
    """

    def _kernel(self) -> torch.Tensor:
        """The correlation kernel (out, in, kD, kH, kW): the transposed
        convolution's weight flipped, in and out swapped (the inverse of
        ``convert.voxelformer._conv_transpose_kernel``)."""
        return self.weight.flip(2, 3, 4).transpose(0, 1)

    def _conv(self, x: torch.Tensor, kernel: torch.Tensor, pad_y,
              pad_x) -> torch.Tensor:
        """x (B, Z, H, W, I), kernel (O, I, 3, kh, kw) -> (B, Z, H', W', O)
        in ``dtype``.  In z the reference has kernel 3, dilation 2, pad 2:
        out[z] = sum_k x[z + 2k - 2] * W[k].  Only the in-range plane pairs
        run: the k=1 tap on every plane, k=0 feeds out[2:] from x[:-2], k=2
        feeds out[:-2] from x[2:], each tap's output summed in ``dtype``."""
        dt = self.dtype
        x, kernel = x.to(dt), kernel.to(dt)
        out = _zslab(x, kernel[:, :, 1], pad_y, pad_x)
        z = x.shape[1]
        if z <= 2:
            return out
        out[:, 2:] += _zslab(x[:, :z - 2], kernel[:, :, 0], pad_y, pad_x)
        out[:, :z - 2] += _zslab(x[:, 2:], kernel[:, :, 2], pad_y, pad_x)
        return out

    def even_conv(self, x: torch.Tensor) -> torch.Tensor:
        """Dense input (stage 1), (B, Z, H, W, C) -> this stage's even grid
        without its bias, (B, Z, H, W, C)."""
        return self._conv(x, self._kernel(), (2, 2), (2, 2))

    def phase_conv(self, e: torch.Tensor,
                   prev_bias: torch.Tensor) -> torch.Tensor:
        """Input with the odd-is-bias structure (stages >= 2): ``e`` the
        previous stage's even grid without its bias (B, Z, m_y, m_x, C),
        ``prev_bias`` that bias.  Returns this stage's even grid without
        its own bias, (B, Z, 2 m_y, 2 m_x, C)."""
        b, z, m_y, m_x, _ = e.shape
        k = self._kernel()
        pads = ((0, (1, 1)), (1, (0, 1)))
        # even[2t + p] = phase p's output t, interleaved in x, then in y
        rows = [torch.stack([
            self._conv(e, k[:, :, :, py::2, px::2], pad_y, pad_x)
            for px, pad_x in pads], dim=4).reshape(b, z, m_y, 2 * m_x, -1)
            for py, pad_y in pads]
        even = torch.stack(rows, dim=3).reshape(b, z, 2 * m_y, 2 * m_x, -1)
        # prev_bias at every in-range input cell, zero outside: a profile
        # over (z, y, x) alone, the range mask correlated with
        # sum_in W * prev_bias (built in fp32, then cast)
        wb = torch.einsum("oizyx,i->ozyx", k.float(), prev_bias.float())
        mask = e.new_ones((1, z, 2 * m_y, 2 * m_x, 1), dtype=self.dtype)
        prof = self._conv(mask, wb[:, None], (2, 2), (2, 2))
        return even + prof.to(even.dtype)

    def even_taps(self, x: torch.Tensor):
        """Stage 1 on the z-major route: z-major x (Z, B, H, W, C) in
        ``dtype`` -> the arguments of :func:`.up_assemble.assemble`: its one
        phase's z-taps, no profile, grid 1 (``even_conv``'s even grid,
        z-major)."""
        return [_ztaps(x, self._kernel().to(self.dtype), (2, 2))], None, 1

    def phase_taps(self, e: torch.Tensor, prev_bias: torch.Tensor):
        """Stages >= 2 on the z-major route: ``e`` the previous stage's
        even grid without its bias, z-major (Z, B, m_y, m_x, C) in
        ``dtype`` -> the arguments of :func:`.up_assemble.assemble`: the
        four phases' z-taps, the bias profile's, grid 2 (``phase_conv``'s
        even grid, z-major).  Each phase runs with the symmetric padding of
        one, so its output holds its window at the offset of its parity;
        the profile's range mask is one plane and one batch."""
        z, _, m_y, m_x, _ = e.shape
        k = self._kernel()
        kd = k.to(self.dtype)
        phases = [_ztaps(e, kd[:, :, :, py::2, px::2], (1, 1))
                  for py in (0, 1) for px in (0, 1)]
        wb = torch.einsum("oizyx,i->ozyx", k.float(), prev_bias.float())
        mask = e.new_ones((1, 1, 2 * m_y, 2 * m_x, 1))
        prof = _ztaps(mask, wb[:, None].to(self.dtype), (2, 2), planes=z)
        # batch-free: a copy only where the one-channel convolution's
        # output is not channels-last
        return phases, Taps(*(t if t is None else t.contiguous()
                              for t in prof)), 2

    def interleave(self, even: torch.Tensor) -> torch.Tensor:
        """The full output: ``even`` plus the bias at the even (y, x)
        cells, the bias alone at every other cell."""
        b, z, h, w, c = even.shape
        bias = self.bias.to(even.dtype)
        row = torch.stack([even + bias, bias.expand_as(even)], dim=4).reshape(
            b, z, h, 2 * w, c)
        return torch.stack([row, bias.expand_as(row)], dim=3).reshape(
            b, z, 2 * h, 2 * w, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The stage alone on a dense NDHWC input."""
        return self.interleave(self.even_conv(x))


class OccUpsampler(nn.ModuleList):
    """The refine_occ upsampler (head:254-258): stages ``0``, ``1``, ...
    (the reference's ``up_sample.{i}``), each doubling (h, w) and keeping
    z, on NDHWC tensors.  The stages pass the compact (even grid, bias)
    form from one to the next, and only ``forward`` builds the full
    lattice."""

    def __init__(self, channels: int, num_stages: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__([_UpStage(channels, dtype)
                          for _ in range(num_stages)])

    def informative(self, x: torch.Tensor):
        """(e, last_bias): the final even grid without its bias, (B, Z,
        H 2^(n-1), W 2^(n-1), C), and that bias (C,).  The full output is
        ``self[-1].interleave(e)``.  A module call, so hooks on the
        upsampler see it."""
        return self(x, informative=True)

    def forward(self, x: torch.Tensor, informative: bool = False):
        """x (B, Z, H, W, C) -> the full output (B, Z, H 2^n, W 2^n, C), or
        with ``informative`` what :meth:`informative` returns.  Where
        :func:`.up_assemble.route` allows, every stage is its convolutions
        on z-major activations and one assembly kernel
        (:meth:`_assembled`); elsewhere ``even_conv`` and ``phase_conv``.
        Counts ``up#calls`` and ``up#fused_calls``."""
        count("up#calls", 1)
        if up_assemble.route(x.device, x.shape[-1], self[0].dtype):
            count("up#fused_calls", 1)
            e = self._assembled(x)
        else:
            e = self[0].even_conv(x)
            for i in range(1, len(self)):
                e = self[i].phase_conv(e, self[i - 1].bias)
        if informative:
            return e, self[-1].bias
        return self[-1].interleave(e)

    def _assembled(self, x: torch.Tensor) -> torch.Tensor:
        """The final even grid without its bias, as the stack-and-add path
        gives it, computed z-major: x transposed once to (Z, B, H, W, C),
        each stage's z-tap convolutions and :func:`.up_assemble.assemble`,
        which writes the next stage's input; returned as a (B, Z, ...)
        view."""
        e = x.to(self[0].dtype).transpose(0, 1).contiguous()
        e = up_assemble.assemble(*self[0].even_taps(e))
        for i in range(1, len(self)):
            e = up_assemble.assemble(*self[i].phase_taps(e,
                                                         self[i - 1].bias))
        return e.transpose(0, 1)


def dense_reference(up: OccUpsampler) -> nn.Sequential:
    """The plain reference of ``up``: the reference's stack of dense
    :class:`ConvTranspose3d` on NCDHW tensors, sharing ``up``'s
    parameters.  The tests and chip_smoke.py hold the factorisation
    against it; no model path runs it."""
    ref = nn.Sequential(*[ConvTranspose3d(s.weight.shape[0], s.dtype)
                          for s in up])
    for r, s in zip(ref, up):
        r.weight, r.bias = s.weight, s.bias
    return ref


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
            # inference forwards on the card replay the branches from CUDA
            # graphs, as the decoder
            self.branch_graphs = GraphCache()
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
                self.up_sample = OccUpsampler(e, upsampler_stages(cfg), dt)

    # -- occupancy -----------------------------------------------------
    def _occ_proj_rows(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, Z, h, w, C) voxel features -> occ_proj's output as rows
        (B, h, w, occ_z, occ_dims), contiguous; occ_proj is pointwise over
        the (h, w) cells, so any grid of cells goes through."""
        cfg = self.cfg
        if cfg.bev_z == cfg.occ_zdim:
            return self.occ_proj(x).permute(0, 2, 3, 1, 4).contiguous()
        b, z, h, w, c = x.shape
        # fuse the z axis: (B, h, w, Z*C) -> (B, h, w, occ_z*occ_dims)
        occ = self.occ_proj(x.permute(0, 2, 3, 1, 4).reshape(b, h, w, z * c))
        return occ.reshape(b, h, w, cfg.occ_zdim, cfg.occ_dims)

    def _occ_logits_grid(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, Z, h, w, C) voxel features -> occupancy logits
        (B, occ_z, h, w, n): occ_proj and the MLP on every (h, w) cell."""
        return self.occ_branches(self._occ_proj_rows(x)).permute(
            0, 3, 1, 2, 4)

    @span("ver#occupancy")
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
        elif cfg.occ_layout == "zhwc_dense":
            with span("ver#upsampler"):
                up = self.up_sample(bev_embed.reshape(b, z, h, w, c))
            logits = self._occ_logits_grid(up)
        else:
            with span("ver#upsampler"):
                even = self.up_sample.informative(
                    bev_embed.reshape(b, z, h, w, c))
            logits = self._bias_aware_logits(*even)
        return logits.reshape(b, -1, logits.shape[-1])

    def _bias_aware_logits(self, e: torch.Tensor,
                           last_bias: torch.Tensor) -> torch.Tensor:
        """The upsampler's even grid ``e`` (B, Z, H'/2, W'/2, C) and last
        bias -> logits (B, occ_z, H', W', n): the even (y, x) cells through
        occ_proj and the MLP, every other cell the logits of the bias.
        Where :func:`.occ_mlp.fused_route` allows, the MLP and the lattice
        are one kernel (:func:`.occ_mlp.occ_mlp_rows` for the bias cell,
        :func:`.occ_mlp.occ_mlp_lattice`); elsewhere the branch module and
        :func:`.occ_mlp.lattice_plain`.  Counts ``occ#calls`` and
        ``occ#fused_calls``."""
        cfg = self.cfg
        bias = last_bias.to(e.dtype)
        rows = self._occ_proj_rows(e + bias)
        bias_rows = self._occ_proj_rows(
            bias.expand(1, cfg.bev_z, 1, 1, cfg.embed_dims)).reshape(
                cfg.occ_zdim, cfg.occ_dims)
        count("occ#calls", 1)
        if fused_route(cfg, e.device, self.occ_proj.dtype, self.training):
            count("occ#fused_calls", 1)
            return occ_mlp_lattice(
                rows, self.occ_branches,
                occ_mlp_rows(bias_rows, self.occ_branches))
        return lattice_plain(rows, self.occ_branches,
                             self.occ_branches(bias_rows))

    def _occupancy_ref_layout(self, bev_embed: torch.Tensor) -> torch.Tensor:
        """The reference's refine_occ pipeline, per sample: the flat
        (bev_num * C) buffer read as (C, Z, H, W) (head:558), the NCDHW
        conv output read as (Z, occ_x, occ_y, C) (head:564), and the
        z-fused occ_proj in that x/y order (head:570-580)."""
        cfg = self.cfg
        b = bev_embed.shape[0]
        c, z = cfg.embed_dims, cfg.bev_z
        t = bev_embed.reshape(b, c, z, cfg.bev_h, cfg.bev_w)
        with span("ver#upsampler"):
            u = self.up_sample(t.permute(0, 2, 3, 4, 1))
        u = u.permute(0, 4, 1, 2, 3)
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

    def _branches(self, hs, raw_preds, refs_before) -> dict:
        """The class scores and decoded boxes (and layouts) of every
        decoder layer."""
        cfg = self.cfg
        outs = {"all_cls_scores": torch.stack([
            branch(hs[lid]) for lid, branch in enumerate(self.cls_branches)]),
            "all_bbox_preds": self._decode_coords(raw_preds, refs_before,
                                                  cfg.pc_range)}
        if cfg.predicts_layout:
            raw_layout = torch.stack([
                branch(hs[lid])
                for lid, branch in enumerate(self.layout_branches)])
            outs["all_layout_preds"] = self._decode_coords(
                raw_layout, refs_before, cfg.layout_range)
        return outs

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
        with span("ver#branches"):
            branches = [self.cls_branches]
            if cfg.predicts_layout:
                branches.append(self.layout_branches)
            outs.update(self.branch_graphs(
                self._branches, (hs, raw_preds, refs_before), branches))
        if not cfg.only_det:
            outs["occupancy_preds"] = self._occupancy_dispatch(bev_embed)
        return outs
