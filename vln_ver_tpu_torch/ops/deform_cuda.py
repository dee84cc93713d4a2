"""Single-level 2D deformable attention: the hand-written CUDA kernel.

:func:`ms_deform_attn_2d_fused` is the port of
``vln_ver_tpu/ops/pallas_deform.py`` (``ms_deform_attn_2d_pallas`` and
``ms_deform_attn_2d_pallas_v2``, one kernel for both).  A CPU tensor takes
the plain version (:func:`.deform_attn.ms_deform_attn_2d`); a CUDA tensor
launches ``csrc/deform_attn_2d.cu`` or raises.  The kernel is built with
``nvcc`` and loaded with ctypes at its first launch (see :mod:`.build`).

:func:`plan_launch` decides how the kernel cuts the work (query chunks,
persistent CTAs, V stages, shared memory).  It is plain Python, so the CPU
tests check it; :func:`cta_tiles` restates the kernel's walk over a plan.

On a CUDA tensor that needs a gradient the call is a
``torch.autograd.Function`` whose backward launches
``csrc/deform_attn_2d_bwd.cu`` (:data:`KERNEL_BWD`, planned by
:func:`plan_backward`); the two kernels count their launches apart.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from .deform_attn import ms_deform_attn_2d

# 32 lanes x 8 loads of one fp32 (csrc/deform_attn_2d.cu kMaxHeadDim)
MAX_HEAD_DIM = 256
# dynamic shared memory a block may use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448
# the kernel's kConsumerWarps
CONSUMER_WARPS = 24
# kHeaderBytes of the kernel: 128 B of mbarriers and a 32-entry tap list
# of 8 B for each consumer warp, ahead of the V stages
HEADER_BYTES = 128 + CONSUMER_WARPS * 32 * 8
MAX_STAGES = 2
# the kernel runs one CTA per SM (its V ring takes most of the SM's
# shared memory, its 25 warps most of the registers)
CTAS_PER_SM = 1
# a query chunk gives every consumer warp the same number of queries
CHUNK_STEP = CONSUMER_WARPS
_INT_MAX = 2 ** 31 - 1


class LaunchPlan(NamedTuple):
    """How one launch cuts the work.  Item ``i`` is query chunk
    ``i % chunks`` of the (slot, head) pair ``i // chunks``, with
    ``chunks = ceil(nq / chunk)``; CTA ``c`` takes items
    ``[c * items_per_cta, (c + 1) * items_per_cta)``."""
    chunk: int           # queries per work item
    items: int           # work items: bs * heads * ceil(nq / chunk)
    items_per_cta: int   # length of each CTA's run of items
    ctas: int            # grid, at most CTAS_PER_SM * SM count
    stages: int          # V tiles in the ring, 1 or 2
    row_stride: int      # elements between V rows in shared memory
    stage_bytes: int     # bytes of one V stage, slack included
    smem_bytes: int      # dynamic shared memory of one CTA


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_launch(bs: int, heads: int, nq: int, hw: int, d: int, elt: int,
                sm_count: int) -> LaunchPlan:
    """The launch plan for value ``(bs, hw, heads, d)`` of ``elt``-byte
    elements (4 fp32, 2 bf16) and ``nq`` queries on a card with
    ``sm_count`` SMs.  Raises ``ValueError`` where one V tile does not fit
    in shared memory or the work does not fit the kernel's int indices.

    A stage holds ``hw`` rows at ``row_stride`` (``d`` rounded up to 4
    bytes) plus slack: a lane reads its whole 32-lane span of 128 B per
    load past the last row's ``d`` values.  The chunk minimises the
    longest CTA run in queries, so that every SM gets an equal share
    (ties go to the larger chunk, fewer items)."""
    if elt not in (2, 4):
        raise ValueError(f"element size {elt}: the kernel takes fp32 (4) "
                         "or bf16 (2)")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside (0, {MAX_HEAD_DIM}]")
    if min(bs, heads, nq, hw, sm_count) < 1:
        raise ValueError(f"empty launch: bs={bs} heads={heads} nq={nq} "
                         f"hw={hw} sm_count={sm_count}")
    row_stride = _round_up(d * elt, 4) // elt
    lane_vals = 4 // elt                 # one fp32 or a bf16 pair per load
    loads = -(-d // (32 * lane_vals))    # loads per lane per row
    stage_bytes = _round_up((hw - 1) * row_stride * elt + 128 * loads, 128)
    if HEADER_BYTES + stage_bytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"one (slot, head) value tile ({hw} x {d}, {elt}-byte values) "
            f"needs {HEADER_BYTES + stage_bytes} B of shared memory, more "
            f"than {MAX_SMEM_BYTES}")
    stages = (MAX_STAGES if HEADER_BYTES + MAX_STAGES * stage_bytes
              <= MAX_SMEM_BYTES else 1)

    pairs = bs * heads
    max_ctas = CTAS_PER_SM * sm_count
    best = None
    for chunk in range(CHUNK_STEP, _round_up(nq, CHUNK_STEP) + 1,
                       CHUNK_STEP):
        items = pairs * -(-nq // chunk)
        per = -(-items // max_ctas)
        key = (per * min(chunk, nq), -chunk)
        if best is None or key < best[0]:
            best = (key, chunk, items, per)
    _, chunk, items, per = best
    if items + per > _INT_MAX:
        raise ValueError(f"{items} work items exceed the kernel's int index")
    return LaunchPlan(chunk=chunk, items=items, items_per_cta=per,
                      ctas=-(-items // per), stages=stages,
                      row_stride=row_stride, stage_bytes=stage_bytes,
                      smem_bytes=HEADER_BYTES + stages * stage_bytes)


def cta_tiles(plan: LaunchPlan, nq: int, cta: int
              ) -> List[Tuple[int, int, int]]:
    """The V tiles CTA ``cta`` stages, in order, as (pair, first query,
    end query): the same arithmetic as the kernel's, for the tests."""
    chunks = -(-nq // plan.chunk)
    i0 = cta * plan.items_per_cta
    i1 = min(plan.items, i0 + plan.items_per_cta)
    first, last = i0 // chunks, (i1 - 1) // chunks
    return [(pair,
             (i0 - first * chunks) * plan.chunk if pair == first else 0,
             min(nq, (i1 - last * chunks) * plan.chunk) if pair == last
             else nq)
            for pair in range(first, last + 1)]


class BackwardPlan(NamedTuple):
    """How one backward launch cuts the work: CTA ``i`` takes queries
    ``[c * chunk, (c + 1) * chunk)`` of the (slot, head) pair
    ``i // chunks``, with ``c = i % chunks``."""
    chunk: int        # queries per CTA
    chunks: int       # CTAs per (slot, head) pair: ceil(nq / chunk)
    ctas: int         # grid: bs * heads * chunks
    smem_bytes: int   # the pair's fp32 dV tile, or 0 without dV


# csrc/deform_attn_2d_bwd.cu: 8 warps a CTA, a warp per query
BWD_WARPS = 8
# a CTA's queries per (slot, head) pair, at the least
BWD_MIN_CHUNK = 64
# the SM's 228 KB of shared memory, less 1 KB that each CTA reserves
SM_SMEM_BYTES = 233472


def plan_backward(bs: int, heads: int, nq: int, hw: int, d: int,
                  sm_count: int, with_dvalue: bool = True) -> BackwardPlan:
    """The backward kernel's grid for value ``(bs, hw, heads, d)`` and
    ``nq`` queries.  Each CTA keeps one (slot, head) pair's dV tile, hw x d
    in fp32, in shared memory, and adds it to device memory at its end;
    the queries of a pair are cut into chunks so that the grid fills one
    wave of the CTAs that fit on the card's ``sm_count`` SMs, but no chunk
    is shorter than ``BWD_MIN_CHUNK`` queries, so that a CTA's final add
    of its tile stays small beside its scatter (4 taps x P points x d per
    query).  Raises ``ValueError`` where the tile does not fit in shared
    memory."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside (0, {MAX_HEAD_DIM}]")
    if min(bs, heads, nq, hw, sm_count) < 1:
        raise ValueError(f"empty launch: bs={bs} heads={heads} nq={nq} "
                         f"hw={hw} sm_count={sm_count}")
    tile = hw * d * 4 if with_dvalue else 0
    if tile > MAX_SMEM_BYTES:
        raise ValueError(
            f"the backward's fp32 dV tile of one (slot, head) pair ({hw} x "
            f"{d}) needs {tile} B of shared memory, more than "
            f"{MAX_SMEM_BYTES}")
    per_sm = max(1, min(2048 // (32 * BWD_WARPS),
                        SM_SMEM_BYTES // (tile + 1024)))
    pairs = bs * heads
    want = -(-per_sm * sm_count // pairs)
    chunks = max(1, min(want, -(-nq // BWD_MIN_CHUNK)))
    chunk = -(-nq // chunks)
    chunks = -(-nq // chunk)
    if pairs * chunks > _INT_MAX:
        raise ValueError(f"{pairs * chunks} CTAs exceed the grid's limit")
    return BackwardPlan(chunk=chunk, chunks=chunks, ctas=pairs * chunks,
                        smem_bytes=tile)


def _check_inputs(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  locations: torch.Tensor, weights: torch.Tensor):
    """Raise on what the kernels do not take; return (bs, H, W, heads, d,
    nq, P)."""
    if len(spatial_shapes) != 1:
        raise ValueError("the CUDA kernel takes one level, got "
                         f"spatial_shapes={spatial_shapes}")
    (H, W), = spatial_shapes
    if value.dim() != 4:
        raise ValueError(f"value must be (bs, H*W, heads, d), got "
                         f"{tuple(value.shape)}")
    bs, hw, heads, d = value.shape
    if locations.dim() != 6:
        raise ValueError("locations must be (bs, nq, heads, 1, P, 2), "
                         f"got {tuple(locations.shape)}")
    nq, P = locations.shape[1], locations.shape[4]
    if hw != H * W:
        raise ValueError(f"value has {hw} rows, spatial shape {H}x{W}")
    if tuple(locations.shape) != (bs, nq, heads, 1, P, 2):
        raise ValueError(f"locations {tuple(locations.shape)} do not "
                         f"match value {tuple(value.shape)}")
    if tuple(weights.shape) != (bs, nq, heads, 1, P):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"locations {tuple(locations.shape)}")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got "
                        f"{value.dtype}")
    if locations.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("locations and weights must be float32")
    for name, t in (("value", value), ("locations", locations),
                    ("weights", weights)):
        if t.device != value.device:
            raise ValueError(f"{name} is on device {t.device}, value "
                             f"on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if locations.data_ptr() % 8:
        raise ValueError("locations must be 8-byte aligned (the kernel "
                         "loads each (x, y) as one float2)")
    return bs, H, W, heads, d, nq, P


_SM_COUNT: Dict[int, int] = {}


def _sm_count(device) -> int:
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


class _CudaKernel:
    """One ctypes-bound kernel: loads its library at first use, counts its
    launches in ``launches`` and keeps the plan of the latest launch in
    ``last_plan``.  Subclasses name the library, the C entry point and its
    arguments' types, and marshal the arguments."""

    library = symbol = ""
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self.last_plan = None
        self._fn = None

    def _launch(self, plan, device, *args) -> None:
        """Call the entry point with ``args`` and the device's current
        stream; raise on a CUDA error, else count the launch."""
        if self._fn is None:
            from .build import load_library
            fn = getattr(load_library(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        self.last_plan = plan


class DeformAttn2dKernel(_CudaKernel):
    """The forward kernel (``csrc/deform_attn_2d.cu``), with its plans
    cached per shape."""

    library, symbol = "deform_attn_2d", "deform_attn_2d_forward"
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
                + [ctypes.c_void_p])

    def __init__(self):
        super().__init__()
        self._plans: Dict[tuple, LaunchPlan] = {}

    def plan(self, bs, heads, nq, hw, d, elt, device) -> LaunchPlan:
        key = (bs, heads, nq, hw, d, elt, _sm_count(device))
        if key not in self._plans:
            self._plans[key] = plan_launch(*key)
        return self._plans[key]

    def __call__(self, value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 locations: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
        bs, H, W, heads, d, nq, P = _check_inputs(value, spatial_shapes,
                                                  locations, weights)
        out = torch.empty((bs, nq, heads * d), dtype=value.dtype,
                          device=value.device)
        if out.numel() == 0:
            return out
        plan = self.plan(bs, heads, nq, H * W, d, value.element_size(),
                         value.device)
        self._launch(plan, value.device, value.data_ptr(),
                     locations.data_ptr(), weights.data_ptr(),
                     out.data_ptr(), bs, H, W, heads, d, nq, P,
                     int(value.dtype == torch.bfloat16), plan.chunk,
                     plan.items, plan.items_per_cta, plan.ctas, plan.stages,
                     plan.row_stride, plan.stage_bytes, plan.smem_bytes)
        return out


class DeformAttn2dBackwardKernel(_CudaKernel):
    """The backward of :class:`DeformAttn2dKernel`
    (``csrc/deform_attn_2d_bwd.cu``), with its own launch count."""

    library, symbol = "deform_attn_2d_bwd", "deform_attn_2d_backward"
    argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                + [ctypes.c_void_p])

    def __call__(self, value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 locations: torch.Tensor, weights: torch.Tensor,
                 grad_out: torch.Tensor, need_value: bool = True,
                 need_locations: bool = True, need_weights: bool = True):
        """(dvalue, dlocations, dweights) of the forward's output gradient
        ``grad_out`` (bs, nq, heads*d), each None where not needed: dvalue
        in the value dtype (summed in an fp32 workspace), the other two
        fp32."""
        bs, H, W, heads, d, nq, P = _check_inputs(value, spatial_shapes,
                                                  locations, weights)
        if tuple(grad_out.shape) != (bs, nq, heads * d):
            raise ValueError(f"grad_out {tuple(grad_out.shape)}, want "
                             f"{(bs, nq, heads * d)}")
        if grad_out.dtype != value.dtype or grad_out.device != value.device:
            raise TypeError(f"grad_out is {grad_out.dtype} on "
                            f"{grad_out.device}, value {value.dtype} on "
                            f"{value.device}")
        if not grad_out.is_contiguous():
            raise ValueError("grad_out must be contiguous")
        if not (need_value or need_locations or need_weights):
            return None, None, None
        dev = value.device
        dv = (torch.zeros(value.shape, dtype=torch.float32, device=dev)
              if need_value else None)
        dl = torch.empty_like(locations) if need_locations else None
        dw = torch.empty_like(weights) if need_weights else None
        plan = plan_backward(bs, heads, nq, H * W, d, _sm_count(dev),
                             with_dvalue=need_value)

        def ptr(t):
            return None if t is None else t.data_ptr()

        self._launch(plan, dev, value.data_ptr(), locations.data_ptr(),
                     weights.data_ptr(), grad_out.data_ptr(), ptr(dv),
                     ptr(dl), ptr(dw), bs, H, W, heads, d, nq, P,
                     int(value.dtype == torch.bfloat16), plan.chunk,
                     plan.chunks, plan.ctas, plan.smem_bytes)
        if dv is not None and value.dtype != torch.float32:
            dv = dv.to(value.dtype)
        return dv, dl, dw


KERNEL = DeformAttn2dKernel()
KERNEL_BWD = DeformAttn2dBackwardKernel()


class _DeformAttn2d(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, locations, weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, locations, weights)
        return KERNEL(value, spatial_shapes, locations, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value, locations, weights = ctx.saved_tensors
        need_v, _, need_l, need_w = ctx.needs_input_grad
        dv, dl, dw = KERNEL_BWD(value, ctx.spatial_shapes, locations,
                                weights, grad_out.contiguous(), need_v,
                                need_l, need_w)
        return dv, None, dl, dw


def ms_deform_attn_2d_fused(value: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int]],
                            locations: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """Deformable attention with the layout of the plain version:
    value ``(bs, H*W, heads, d)``, locations ``(bs, nq, heads, 1, P, 2)``,
    weights ``(bs, nq, heads, 1, P)``; returns ``(bs, nq, heads*d)`` in
    the value dtype.  CPU tensors take the plain version (and its
    autograd); CUDA tensors launch the kernel, and where an input needs a
    gradient its backward launches the backward kernel."""
    if value.device.type == "cpu":
        return ms_deform_attn_2d(value, spatial_shapes, locations, weights)
    if value.device.type != "cuda":
        raise ValueError(f"no deformable-attention path for device "
                         f"{value.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, locations, weights)):
        return _DeformAttn2d.apply(value, spatial_shapes, locations, weights)
    return KERNEL(value, spatial_shapes, locations, weights)
