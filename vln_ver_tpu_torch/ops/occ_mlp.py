"""The occupancy MLP and its logits lattice: the hand-written CUDA kernel.

The occupancy branch (``models.head.ClsBranch`` with two hidden layers:
Dense, LayerNorm, ReLU, twice, then an fp32 Dense) runs on every row of
``occ_proj``'s output.  :func:`occ_mlp_rows` applies it to rows
``(..., D)``; :func:`occ_mlp_lattice` to the even (y, x) cells of the
upsampled grid, ``(B, h2, w2, occ_z, D)``, and writes the whole
``(B, occ_z, 2 h2, 2 w2, n)`` fp32 lattice: each row's logits at its even
cell, the bias cell's logits of its plane at the three cells beside it.

A CPU tensor takes the plain version (the branch module itself, and
:func:`lattice_plain`, the one owner of the interleave, which the head's
eager path calls too); a CUDA tensor launches ``csrc/occ_mlp.cu``
(:data:`KERNEL`) or raises.  The kernel has no backward and computes in bf16 with fp32 statistics and an
fp32 last layer, so :func:`fused_route` gives it only inference on the
card with a bf16 ``occ_proj``; the head runs its eager chain everywhere
else.  The library is built with ``nvcc`` and loaded with ctypes at the
first launch (see :mod:`.build`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import nn

from .build import CudaKernel, sm_count

# csrc/occ_mlp.cu: kMaxD, kMaxN, kWarps, kRows
MAX_DIMS, MAX_CLASSES = 128, 32
WARPS, ROWS_PER_WARP = 16, 16


def takes(num_fcs: int, dims: int, classes: int) -> bool:
    """Whether the kernel computes a ``ClsBranch(dims, classes,
    num_fcs)``: two hidden layers, ``dims`` a multiple of 16 up to
    :data:`MAX_DIMS` (W1 and W2 in bf16, 2 dims^2 x 2 bytes, stay in one
    block's shared memory), at most :data:`MAX_CLASSES` outputs."""
    return (num_fcs == 2 and 0 < dims <= MAX_DIMS and dims % 16 == 0
            and 0 < classes <= MAX_CLASSES)


def fused_route(cfg, device: torch.device, proj_dtype: torch.dtype,
                training: bool) -> bool:
    """Whether a call of the head's even-cell occupancy path (``occ_layout``
    ``'zhwc'``) on ``device`` takes the kernel: autograd off, the card, the
    module in ``eval()``, ``occ_proj`` computing in bf16, and a branch the
    kernel :func:`takes` (what ``utils.cuda_graph`` observes, plus what the
    kernel computes).  Anything else keeps the eager chain."""
    return (device.type == "cuda" and not torch.is_grad_enabled()
            and not training and proj_dtype == torch.bfloat16
            and cfg.occ_layout == "zhwc"
            and takes(cfg.num_occ_fcs, cfg.occ_dims, cfg.occupancy_classes))


class BranchParams(NamedTuple):
    """A two-hidden-layer ``ClsBranch``'s parameters, as the fp32 tensors
    they are (read at every call: tensor parallelism swaps ``.data``)."""
    w1: torch.Tensor
    b1: torch.Tensor
    g1: torch.Tensor
    be1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    g2: torch.Tensor
    be2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    eps: float


def branch_params(branch: nn.Sequential) -> BranchParams:
    """The parameters of ``branch`` (Dense, LN, ReLU, Dense, LN, ReLU,
    Dense); raises on another structure or LayerNorms of other eps."""
    if len(branch) != 7 or branch[1].eps != branch[4].eps:
        raise ValueError("the kernel takes a ClsBranch of two hidden layers "
                         f"with one LayerNorm eps, got {branch}")
    d1, n1, d2, n2, d3 = (branch[i] for i in (0, 1, 3, 4, 6))
    return BranchParams(d1.weight, d1.bias, n1.weight, n1.bias, d2.weight,
                        d2.bias, n2.weight, n2.bias, d3.weight, d3.bias,
                        float(n1.eps))


def plan_grid(rows: int, sm_count: int) -> int:
    """Blocks of a launch over ``rows``: one persistent block an SM (its
    weights take most of the SM's shared memory), fewer where there are
    fewer tiles than warps to take them."""
    tiles = -(-rows // ROWS_PER_WARP)
    return max(1, min(sm_count, -(-tiles // WARPS)))


def lattice_plain(x: torch.Tensor, branch: nn.Sequential,
                  bias_logits: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`occ_mlp_lattice`: the branch on every
    row, the bias cells' logits expanded and the even cells written in."""
    logits = branch(x).permute(0, 3, 1, 2, 4)
    b, oz, h2, w2, n = logits.shape
    full = bias_logits.reshape(1, oz, 1, 1, n).expand(
        b, oz, 2 * h2, 2 * w2, n).clone()
    full[:, :, ::2, ::2] = logits
    return full


class OccMlpKernel(CudaKernel):
    """``csrc/occ_mlp.cu`` with its launch count (``launches``)."""

    library, symbol = "occ_mlp", "occ_mlp_forward"
    argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong]
                + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p])

    @staticmethod
    def _check(x: torch.Tensor, prm: BranchParams):
        if x.device.type != "cuda":
            raise ValueError(f"the occupancy MLP kernel runs on the card, "
                             f"got a tensor on {x.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the rows must be bfloat16, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("the rows must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("the rows must be 16-byte aligned")
        if x.numel() // max(x.shape[-1], 1) >= 2 ** 31:
            raise ValueError("the kernel takes fewer than 2^31 rows")
        d, n = x.shape[-1], prm.w3.shape[0]
        if not takes(2, d, n):
            raise ValueError(f"the kernel takes D a multiple of 16 up to "
                             f"{MAX_DIMS} and n up to {MAX_CLASSES}, got "
                             f"D={d}, n={n}")
        shapes = {"w1": (d, d), "b1": (d,), "g1": (d,), "be1": (d,),
                  "w2": (d, d), "b2": (d,), "g2": (d,), "be2": (d,),
                  "w3": (n, d), "b3": (n,)}
        for name, shape in shapes.items():
            t = getattr(prm, name)
            if tuple(t.shape) != shape or t.dtype != torch.float32:
                raise ValueError(f"{name} must be fp32 {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {x.device}")
        return d, n

    def _run(self, x, prm, bias_logits, out, lattice_dims):
        rows = x.numel() // x.shape[-1]
        h2, w2, oz = lattice_dims
        blocks = plan_grid(rows, sm_count(x.device))
        self._launch(x.device, x.data_ptr(),
                     *(getattr(prm, k).data_ptr()
                       for k in BranchParams._fields[:-1]),
                     None if bias_logits is None else bias_logits.data_ptr(),
                     out.data_ptr(), rows, x.shape[-1], prm.w3.shape[0],
                     int(bias_logits is not None), h2, w2, oz, prm.eps,
                     blocks)
        return out

    def rows(self, x: torch.Tensor, prm: BranchParams) -> torch.Tensor:
        """x (..., D) bf16 -> (..., n) fp32 logits."""
        d, n = self._check(x, prm)
        out = torch.empty((*x.shape[:-1], n), dtype=torch.float32,
                          device=x.device)
        if out.numel() == 0:
            return out
        return self._run(x, prm, None, out, (0, 0, 0))

    def lattice(self, x: torch.Tensor, prm: BranchParams,
                bias_logits: torch.Tensor) -> torch.Tensor:
        """x (B, h2, w2, occ_z, D) bf16, bias_logits (occ_z, n) fp32 ->
        the (B, occ_z, 2 h2, 2 w2, n) fp32 lattice."""
        d, n = self._check(x, prm)
        if x.dim() != 5:
            raise ValueError(f"x must be (B, h2, w2, occ_z, D), got "
                             f"{tuple(x.shape)}")
        b, h2, w2, oz, _ = x.shape
        if (tuple(bias_logits.shape) != (oz, n)
                or bias_logits.dtype != torch.float32
                or bias_logits.device != x.device
                or not bias_logits.is_contiguous()):
            raise ValueError(f"bias_logits must be contiguous fp32 "
                             f"{(oz, n)} on {x.device}, got "
                             f"{bias_logits.dtype} "
                             f"{tuple(bias_logits.shape)}")
        out = torch.empty((b, oz, 2 * h2, 2 * w2, n), dtype=torch.float32,
                          device=x.device)
        if out.numel() == 0:
            return out
        return self._run(x, prm, bias_logits, out, (h2, w2, oz))


KERNEL = OccMlpKernel()


def occ_mlp_rows(x: torch.Tensor, branch: nn.Sequential) -> torch.Tensor:
    """``branch`` on rows ``x`` (..., D): the plain version on the CPU,
    the kernel on the card."""
    if x.device.type == "cpu":
        return branch(x)
    return KERNEL.rows(x, branch_params(branch))


def occ_mlp_lattice(x: torch.Tensor, branch: nn.Sequential,
                    bias_logits: torch.Tensor) -> torch.Tensor:
    """``branch`` on the even cells ``x`` (B, h2, w2, occ_z, D) and the
    full (B, occ_z, 2 h2, 2 w2, n) lattice with ``bias_logits`` (occ_z, n)
    at every other cell: the plain version (:func:`lattice_plain`) on the
    CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return lattice_plain(x, branch, bias_logits)
    return KERNEL.lattice(x, branch_params(branch), bias_logits)
