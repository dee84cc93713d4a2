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
import heapq
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
    """How one backward launch cuts the work.  The value CTAs come first,
    ``qsplit`` of them, one thread-block cluster, for each (slot, head,
    32-channel slice): CTA ``i < value_ctas`` is rank ``i % qsplit`` of
    the unit ``u = i // qsplit``, channels ``[32 * (u % slices), ... +
    32)`` of dV for the (slot, head) pair ``u // slices``; its first
    ``walkers`` warps each take every ``walkers * qsplit``-th query into a
    private copy (:func:`backward_cta_work`).  CTA ``value_ctas + j`` sums
    dweights and dlocations of queries ``[c * chunk, (c + 1) * chunk)`` of
    the pair ``j // chunks``, with ``c = j % chunks``, over all channels.
    The grid is padded to whole clusters with CTAs that do nothing."""
    value_ctas: int   # bs * heads * slices * qsplit, or 0 without dvalue
    slices: int       # 32-channel slices of d: ceil(d / 32)
    walkers: int      # warps of a value CTA, each with its own dV copy
    qsplit: int       # value CTAs (one cluster) per (slot, head, slice)
    chunk: int        # queries of a sums CTA (0 without the sums)
    chunks: int       # sums CTAs per pair: ceil(nq / chunk), or 0
    sum_ctas: int     # bs * heads * chunks
    ctas: int         # value_ctas + sum_ctas, padded to whole clusters
    row_stride: int   # elements between staged V rows (sums CTAs)
    tile_bytes: int   # a sums CTA's staged V tile, or 0
    acc_bytes: int    # one fp32 dV slice copy, hw x 32 x 4, or 0
    smem_bytes: int   # dynamic shared memory of one CTA


# csrc/deform_attn_2d_bwd.cu: kWarps, kSlice, kBarrierBytes and the per-warp
# tap lists of the two kinds of CTA (kSumListBytes, kValueListBytes)
BWD_WARPS = 8
BWD_SLICE = 32
BWD_BARRIER_BYTES = 128
BWD_SUM_LIST_BYTES = 32 * 4
BWD_VALUE_LIST_BYTES = 32 * 8
# the SM's 228 KB of shared memory, less 1 KB that each CTA reserves
SM_SMEM_BYTES = 233472
# Cost model of one query step (8 points x 4 taps), in warp instructions,
# for balancing the two kinds of CTA: the tap setup and list, a value
# CTA's merge of taps that share a row, the reduce-scatter of the sums
# CTAs, and per tap inside the map (about 24 of 32 on the main path's
# data) a value CTA's two list reads, load, FMA and store, and a sums
# CTA's list read plus, per lane load, its load and FMA (fp32) or load,
# two unpacks and two FMAs (bf16 pair).
_STEP_SETUP, _STEP_MERGE, _STEP_REDUCE, _STEP_TAPS = 40, 20, 130, 24
_VALUE_PER_TAP = 5
# a value CTA's copies are sized so that three CTAs fit on an SM
_VALUE_REGION = SM_SMEM_BYTES // 3 - 1024 - BWD_BARRIER_BYTES
# a value walker is bound by the latency of its steps, so the query split
# aims at this many value CTAs per SM; a cluster holds at most 8 CTAs
_VALUE_CTAS_PER_SM, _MAX_CLUSTER = 2, 8


def _bwd_costs(plan: BackwardPlan, nq: int, d: int,
               elt: int) -> Tuple[int, int]:
    """Modelled cost of a value CTA and of a sums CTA (one query step
    each: both scale alike with P)."""
    kc = -(-d // (32 * (4 // elt)))
    per_load = 2 if elt == 4 else 5
    value = (nq * (_STEP_SETUP + _STEP_MERGE + _STEP_TAPS * _VALUE_PER_TAP)
             // plan.qsplit)
    sums = plan.chunk * (_STEP_SETUP + _STEP_REDUCE
                         + _STEP_TAPS * (1 + kc * per_load))
    return value, sums


def backward_sm_loads(plan: BackwardPlan, nq: int, d: int, elt: int,
                      sm_count: int) -> List[int]:
    """Each SM's modelled work when the grid's CTAs go, in order, to the
    least-loaded SM (list scheduling, the block scheduler's greedy fill)."""
    value, sums = _bwd_costs(plan, nq, d, elt)
    loads = [0] * sm_count
    heap = [(0, sm) for sm in range(sm_count)]
    for cta in range(plan.ctas):
        load, sm = heapq.heappop(heap)
        if cta < plan.value_ctas:
            load += value
        elif cta < plan.value_ctas + plan.sum_ctas:
            load += sums
        loads[sm] = load
        heapq.heappush(heap, (load, sm))
    return loads


def plan_backward(bs: int, heads: int, nq: int, hw: int, d: int, elt: int,
                  sm_count: int, need_value: bool = True,
                  need_sums: bool = True) -> BackwardPlan:
    """The backward kernel's grid for value ``(bs, hw, heads, d)`` of
    ``elt``-byte elements and ``nq`` queries on ``sm_count`` SMs, for dV
    (``need_value``) and dlocations / dweights (``need_sums``).

    Value CTAs keep a (slot, head, 32-channel) slice of dV, hw x 32 fp32,
    in shared memory over all queries, one copy for each of ``walkers``
    warps (as many as fit in a third of the SM, at most 8), each copy with
    a tap list; sums CTAs stage one (slot, head) V tile, hw rows at
    ``row_stride`` (``d`` rounded up to 4 bytes), followed by 8 per-warp
    tap lists.  Each (slot, head, slice) is split over ``qsplit`` value
    CTAs, the least power of two (at most 8) that gives the card two value
    CTAs an SM.  The sums CTAs' chunk (a multiple of 8 queries, one per
    warp and round) minimises the heaviest SM's modelled work
    (:func:`backward_sm_loads`; ties go to fewer chunks), trying up to 4
    sums CTAs per SM.  Raises ``ValueError``
    where a region does not fit in shared memory or the grid does not fit
    the kernel's int indices."""
    if elt not in (2, 4):
        raise ValueError(f"element size {elt}: the kernel takes fp32 (4) "
                         "or bf16 (2)")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside (0, {MAX_HEAD_DIM}]")
    if min(bs, heads, nq, hw, sm_count) < 1:
        raise ValueError(f"empty launch: bs={bs} heads={heads} nq={nq} "
                         f"hw={hw} sm_count={sm_count}")
    if not (need_value or need_sums):
        raise ValueError("nothing to compute")
    pairs = bs * heads
    slices = -(-d // BWD_SLICE)
    row_stride = _round_up(d * elt, 4) // elt
    tile = _round_up(hw * row_stride * elt, 128) if need_sums else 0
    acc = hw * BWD_SLICE * 4 if need_value else 0
    copy = acc + BWD_VALUE_LIST_BYTES
    walkers = (max(1, min(BWD_WARPS, _VALUE_REGION // copy)) if need_value
               else 0)
    region = max(tile + BWD_WARPS * BWD_SUM_LIST_BYTES if need_sums else 0,
                 walkers * copy)
    smem = BWD_BARRIER_BYTES + region
    if smem > MAX_SMEM_BYTES:
        what = (f"V tile ({hw} x {d}, {elt}-byte values)" if tile >= acc
                else f"fp32 dV slice ({hw} x {BWD_SLICE})")
        raise ValueError(f"the backward's {what} of one (slot, head) pair "
                         f"needs {smem} B of shared memory, more than "
                         f"{MAX_SMEM_BYTES}")
    qsplit = 1
    if need_value:
        while (qsplit < _MAX_CLUSTER
               and pairs * slices * qsplit < _VALUE_CTAS_PER_SM * sm_count):
            qsplit *= 2
    value_ctas = pairs * slices * qsplit if need_value else 0
    chunk = chunks = 0
    if need_sums:
        best = None
        top = max(1, min(-(-nq // BWD_WARPS),
                         -(-4 * sm_count // pairs)))
        for want in range(1, top + 1):
            c = _round_up(-(-nq // want), BWD_WARPS)
            n = -(-nq // c)
            trial = BackwardPlan(value_ctas, slices, walkers, qsplit, c, n,
                                 pairs * n, value_ctas + pairs * n,
                                 row_stride, tile, acc, smem)
            key = (max(backward_sm_loads(trial, nq, d, elt, sm_count)), n)
            if best is None or key < best[0]:
                best = (key, c, n)
        _, chunk, chunks = best
    ctas = _round_up(value_ctas + pairs * chunks, qsplit)
    if ctas > _INT_MAX:
        raise ValueError(f"{ctas} CTAs exceed the grid's limit")
    return BackwardPlan(value_ctas=value_ctas, slices=slices,
                        walkers=walkers, qsplit=qsplit, chunk=chunk,
                        chunks=chunks, sum_ctas=pairs * chunks, ctas=ctas,
                        row_stride=row_stride, tile_bytes=tile,
                        acc_bytes=acc, smem_bytes=smem)


def backward_cta_work(plan: BackwardPlan, nq: int, d: int, cta: int
                      ) -> Tuple[str, int, int, int, Sequence[int]]:
    """What CTA ``cta`` computes, as (kind, pair, first channel, end
    channel, queries), kind "value" (its share of a dV slice), "sums"
    (dweights and dlocations) or "pad" (nothing): the kernel's arithmetic,
    for the tests."""
    if cta < plan.value_ctas:
        unit, rank = divmod(cta, plan.qsplit)
        pair, s = divmod(unit, plan.slices)
        c0 = s * BWD_SLICE
        g = plan.walkers * plan.qsplit
        first = rank * plan.walkers
        queries = sorted(q for k in range(first, first + plan.walkers)
                         for q in range(k, nq, g))
        return ("value", pair, c0, min(d, c0 + BWD_SLICE), queries)
    if cta >= plan.value_ctas + plan.sum_ctas:
        return ("pad", -1, 0, 0, range(0))
    pair, c = divmod(cta - plan.value_ctas, plan.chunks)
    q0 = c * plan.chunk
    return ("sums", pair, 0, d, range(q0, min(nq, q0 + plan.chunk)))


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
    launches in ``launches`` and keeps the plan and the query count of the
    latest launch in ``last_plan`` and ``last_nq``.  Subclasses name the
    library, the C entry point and its arguments' types, and marshal the
    arguments."""

    library = symbol = ""
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self.last_plan = None
        self.last_nq = None
        self._fn = None

    def _launch(self, plan, nq, device, *args) -> None:
        """Call the entry point with ``args`` and the device's current
        stream; raise on a CUDA error, else count the launch of ``nq``
        queries a slot."""
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
        self.last_nq = nq

    def mark(self) -> tuple:
        """The launch count and the latest launch's plan and query count."""
        return self.launches, self.last_plan, self.last_nq

    def restore(self, mark: tuple) -> None:
        """Back to ``mark``: a CUDA graph's capture launched nothing."""
        self.launches, self.last_plan, self.last_nq = mark

    def replayed(self, before: tuple, after: tuple) -> None:
        """A CUDA graph whose capture ran from the mark ``before`` to the
        mark ``after`` replayed: count its launches again, and keep its
        last launch as the latest."""
        if after[0] != before[0]:
            self.launches += after[0] - before[0]
            self.last_plan, self.last_nq = after[1], after[2]


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
        self._launch(plan, nq, value.device, value.data_ptr(),
                     locations.data_ptr(), weights.data_ptr(),
                     out.data_ptr(), bs, H, W, heads, d, nq, P,
                     int(value.dtype == torch.bfloat16), plan.chunk,
                     plan.items, plan.items_per_cta, plan.ctas, plan.stages,
                     plan.row_stride, plan.stage_bytes, plan.smem_bytes)
        return out


class DeformAttn2dBackwardKernel(_CudaKernel):
    """The backward of :class:`DeformAttn2dKernel`
    (``csrc/deform_attn_2d_bwd.cu``), with its own launch count and its
    plans cached per shape."""

    library, symbol = "deform_attn_2d_bwd", "deform_attn_2d_backward"
    argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 19
                + [ctypes.c_void_p])

    def __init__(self):
        super().__init__()
        self._plans: Dict[tuple, BackwardPlan] = {}

    def plan(self, bs, heads, nq, hw, d, elt, device, need_value,
             need_sums) -> BackwardPlan:
        key = (bs, heads, nq, hw, d, elt, _sm_count(device), need_value,
               need_sums)
        if key not in self._plans:
            self._plans[key] = plan_backward(*key)
        return self._plans[key]

    def __call__(self, value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 locations: torch.Tensor, weights: torch.Tensor,
                 grad_out: torch.Tensor, need_value: bool = True,
                 need_locations: bool = True, need_weights: bool = True):
        """(dvalue, dlocations, dweights) of the forward's output gradient
        ``grad_out`` (bs, nq, heads*d), each None where not needed: dvalue
        in the value dtype, written by the kernel as it is, the other two
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
        need_sums = need_locations or need_weights
        if not (need_value or need_sums):
            return None, None, None
        dev = value.device
        plan = self.plan(bs, heads, nq, H * W, d, value.element_size(), dev,
                         need_value, need_sums)
        dv = torch.empty_like(value) if need_value else None
        dl = torch.empty_like(locations) if need_locations else None
        dw = torch.empty_like(weights) if need_weights else None

        def ptr(t):
            return None if t is None else t.data_ptr()

        self._launch(plan, nq, dev, value.data_ptr(), locations.data_ptr(),
                     weights.data_ptr(), grad_out.data_ptr(), ptr(dv),
                     ptr(dl), ptr(dw), bs, H, W, heads, d, nq, P,
                     int(value.dtype == torch.bfloat16), plan.value_ctas,
                     plan.slices, plan.walkers, plan.qsplit, plan.chunk,
                     plan.chunks, plan.ctas,
                     plan.row_stride, plan.tile_bytes, plan.acc_bytes,
                     plan.smem_bytes)
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
