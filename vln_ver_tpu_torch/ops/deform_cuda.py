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

Forward only: a CUDA call whose inputs need a gradient raises
``NotImplementedError`` (the backward kernel is ROADMAP Queue 2 item 3).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

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


class DeformAttn2dKernel:
    """Owns the loaded library, counts launches in ``launches`` and keeps
    the plan of the latest launch in ``last_plan``."""

    def __init__(self):
        self.launches = 0
        self.last_plan = None
        self._fn = None
        self._plans: Dict[tuple, LaunchPlan] = {}
        self._sm_count: Dict[int, int] = {}

    def _entry(self):
        if self._fn is None:
            from .build import load_library
            fn = load_library("deform_attn_2d").deform_attn_2d_forward
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def plan(self, bs, heads, nq, hw, d, elt, device) -> LaunchPlan:
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        if index not in self._sm_count:
            self._sm_count[index] = torch.cuda.get_device_properties(
                index).multi_processor_count
        key = (bs, heads, nq, hw, d, elt, self._sm_count[index])
        if key not in self._plans:
            self._plans[key] = plan_launch(*key)
        return self._plans[key]

    def __call__(self, value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 locations: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
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
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (value, locations, weights)):
            raise NotImplementedError(
                "the CUDA deformable-attention kernel is forward-only; its "
                "backward is ROADMAP Queue 2 item 3. Run under "
                "torch.inference_mode() or torch.no_grad().")

        out = torch.empty((bs, nq, heads * d), dtype=value.dtype,
                          device=value.device)
        if out.numel() == 0:
            return out
        plan = self.plan(bs, heads, nq, hw, d, value.element_size(),
                         value.device)
        fn = self._entry()
        with torch.cuda.device(value.device):
            stream = torch.cuda.current_stream(value.device).cuda_stream
            err = fn(value.data_ptr(), locations.data_ptr(),
                     weights.data_ptr(), out.data_ptr(), bs, H, W, heads, d,
                     nq, P, int(value.dtype == torch.bfloat16), plan.chunk,
                     plan.items, plan.items_per_cta, plan.ctas, plan.stages,
                     plan.row_stride, plan.stage_bytes, plan.smem_bytes,
                     stream)
        if err != 0:
            raise RuntimeError(f"deform_attn_2d launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        self.last_plan = plan
        return out


KERNEL = DeformAttn2dKernel()


def ms_deform_attn_2d_fused(value: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int]],
                            locations: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """Deformable attention with the layout of the plain version:
    value ``(bs, H*W, heads, d)``, locations ``(bs, nq, heads, 1, P, 2)``,
    weights ``(bs, nq, heads, 1, P)``; returns ``(bs, nq, heads*d)`` in
    the value dtype.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if value.device.type == "cpu":
        return ms_deform_attn_2d(value, spatial_shapes, locations, weights)
    if value.device.type != "cuda":
        raise ValueError(f"no deformable-attention path for device "
                         f"{value.device}")
    return KERNEL(value, spatial_shapes, locations, weights)
