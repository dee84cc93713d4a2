"""The refine_occ upsampler's even-grid assembly: the hand-written CUDA
kernel.

A stage of the upsampler (``models.head._UpStage``) is a stride-1
correlation on its even grid, run as cuDNN convolutions: one a z-tap
(k = 1 over every plane, k = 0 over planes ``:Z-2`` feeding planes ``2:``,
k = 2 over planes ``2:`` feeding planes ``:Z-2``) of each parity phase
(one at stage 1, four after), plus, after stage 1, the batch-free bias
profile of the previous stage's bias.  On the z-major route the
activations are ``(Z, B, h, w, C)`` and the convolutions leave each
output where cuDNN wrote it (:class:`Taps`); :func:`assemble` sums, for
every cell of the stage's even grid ``(Z, B, Ho, Wo, C)``, the taps that
feed it and the profile in fp32, rounds once to the taps' type and writes
the cell once.

Phase ``(py, px)`` (in the order ``2 py + px``) is computed with the
symmetric padding of one: its output cell ``(t + py, s + px)`` is the even
grid's cell ``(2 t + py, 2 s + px)``.  At stage 1 (``grid`` 1) the one
phase's output is the even grid.

A CPU tensor takes the plain version (:func:`assemble_plain`, the same
sums in the same order, so the two agree bit for bit); a CUDA tensor
launches ``csrc/up_assemble.cu`` (:data:`KERNEL`) or raises.  The kernel
has no backward, so :func:`route` gives it only calls with autograd off;
the upsampler keeps its stack-and-add path everywhere else.  The library
is built with ``nvcc`` and loaded with ctypes at the first launch (see
:mod:`.build`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from .build import CudaKernel

# csrc/up_assemble.cu: kSources
SOURCES = 5
DTYPES = (torch.bfloat16, torch.float32)


class Taps(NamedTuple):
    """One convolution's z-tap outputs, z-major and channels-last: ``mid``
    the k = 1 tap over every plane, ``(Z, B, h, w, C)``; ``low`` the k = 0
    tap over planes ``:Z-2`` and ``high`` the k = 2 tap over planes
    ``2:``, each ``(Z - 2, B, h, w, C)``, None at Z <= 2.  A source of one
    plane and one batch (the bias profile) stands for every plane and
    batch."""
    mid: torch.Tensor
    low: Optional[torch.Tensor]
    high: Optional[torch.Tensor]


def route(device: torch.device, channels: int, dtype: torch.dtype) -> bool:
    """Whether an upsampler call on ``device`` takes the kernel: the card,
    autograd off (the kernel has no backward), stages computing in bf16 or
    fp32, and ``channels`` a multiple of 8 (16-byte vectors).  Anything
    else keeps the stack-and-add path."""
    return (device.type == "cuda" and not torch.is_grad_enabled()
            and dtype in DTYPES and channels % 8 == 0)


def _geometry(phases: Sequence[Taps], grid: int):
    """(Z, B, m_y, m_x, C, offsets): the planes, batch, phase window and
    channels of a stage, each phase's window offset; raises where the
    phases do not fit the grid."""
    if grid not in (1, 2) or len(phases) != grid * grid:
        raise ValueError(f"a stage has 1 phase on grid 1 or 4 on grid 2, "
                         f"got {len(phases)} on grid {grid}")
    z, b, m_y, m_x, c = phases[0].mid.shape
    offsets = [(p // grid, p % grid) if grid == 2 else (0, 0)
               for p in range(grid * grid)]
    for t, (oy, ox) in zip(phases, offsets):
        want = (z, b, m_y + oy, m_x + ox, c)
        if tuple(t.mid.shape) != want:
            raise ValueError(f"phase taps of {want} expected, got "
                             f"{tuple(t.mid.shape)}")
        for side in (t.low, t.high):
            if (side is None) != (z <= 2) or (
                    side is not None and tuple(side.shape) != (z - 2,
                                                               *want[1:])):
                raise ValueError(f"the k = 0 and k = 2 taps of {z - 2} "
                                 f"planes expected at Z = {z}")
    return z, b, m_y, m_x, c, offsets


def _zsum(t: Taps, z: int) -> torch.Tensor:
    """The fp32 sum of the taps feeding each of ``z`` planes: mid, then
    low at planes ``2:``, then high at planes ``:z-2``."""
    out = t.mid.float().expand(z, *t.mid.shape[1:]).clone()
    if t.low is not None:
        out[2:] += t.low.float()
        out[:z - 2] += t.high.float()
    return out


def assemble_plain(phases: Sequence[Taps], prof: Optional[Taps],
                   grid: int) -> torch.Tensor:
    """The plain version of :func:`assemble`: each phase's z-tap sum cut to
    its window and interleaved into the even grid, plus the profile's z-tap
    sum, in fp32, rounded once."""
    z, b, m_y, m_x, c, offsets = _geometry(phases, grid)
    sums = [_zsum(t, z)[:, :, oy:oy + m_y, ox:ox + m_x]
            for t, (oy, ox) in zip(phases, offsets)]
    if grid == 1:
        even = sums[0]
    else:   # (py, px, Z, B, t, s, C) -> (Z, B, 2 t + py, 2 s + px, C)
        even = torch.stack(sums).reshape(2, 2, z, b, m_y, m_x, c).permute(
            2, 3, 4, 0, 5, 1, 6).reshape(z, b, 2 * m_y, 2 * m_x, c)
    if prof is not None:
        even = even + _zsum(prof, z)
    return even.to(phases[0].mid.dtype)


class UpAssembleKernel(CudaKernel):
    """``csrc/up_assemble.cu`` with its launch count (``launches``)."""

    library, symbol = "up_assemble", "up_assemble"
    refuses = ("every tap and the output 16-byte aligned, every stride and "
               "C a multiple of 16 bytes' worth of channels")
    argtypes = ([ctypes.POINTER(ctypes.c_void_p),
                 ctypes.POINTER(ctypes.c_longlong),
                 ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
                + [ctypes.c_int] * 8 + [ctypes.c_void_p])

    @staticmethod
    def _source(t: Taps, dtype, device):
        """The taps' pointers and ``mid``'s (plane, batch, row, column)
        element strides, 0 along a dimension of one (the profile
        broadcasts); raises on what the entry point cannot see (the
        alignment and the multiples of 16 bytes are its own checks)."""
        strides = tuple(0 if n == 1 else s for n, s in
                        zip(t.mid.shape[:4], t.mid.stride()[:4]))
        for x in t:
            if x is None:
                continue
            if x.device != device or x.dtype != dtype:
                raise ValueError(f"every tap must be {dtype} on {device}, "
                                 f"got {x.dtype} on {x.device}")
            if x.stride(-1) != 1:
                raise ValueError("every tap's channels must be contiguous")
            if any(n > 1 and s != want for n, s, want in
                   zip(x.shape[:4], x.stride()[:4], strides)):
                raise ValueError("the taps of one convolution must share "
                                 "their strides")
        return [None if x is None else x.data_ptr() for x in t], strides

    def __call__(self, phases: Sequence[Taps], prof: Optional[Taps],
                 grid: int) -> torch.Tensor:
        z, b, m_y, m_x, c, offsets = _geometry(phases, grid)
        x = phases[0].mid
        if x.device.type != "cuda":
            raise ValueError(f"the assembly kernel runs on the card, got a "
                             f"tensor on {x.device}")
        if x.dtype not in DTYPES:
            raise TypeError(f"the taps must be bfloat16 or float32, got "
                            f"{x.dtype}")
        ho, wo = grid * m_y, grid * m_x
        if prof is not None and (
                prof.mid.shape[0] != 1 or prof.mid.shape[1] != 1
                or tuple(prof.mid.shape[2:]) != (ho, wo, c)
                or (prof.low is None) != (z <= 2)):
            raise ValueError(f"the profile's taps must be (1, 1, {ho}, {wo}, "
                             f"{c}), got {tuple(prof.mid.shape)}")
        sources = [*zip(phases, offsets)]
        sources += [(None, (0, 0))] * (SOURCES - 1 - len(sources))
        sources.append((prof, (0, 0)))
        ptrs, strides, offs = [], [], []
        for t, off in sources:
            p, st = ((None,) * 3, (0,) * 4) if t is None else self._source(
                t, x.dtype, x.device)
            ptrs += p
            strides += st
            offs += off
        out = torch.empty((z, b, ho, wo, c), dtype=x.dtype, device=x.device)
        self._launch(x.device, (ctypes.c_void_p * len(ptrs))(*ptrs),
                     (ctypes.c_longlong * len(strides))(*strides),
                     (ctypes.c_int * len(offs))(*offs), out.data_ptr(), z,
                     b, ho, wo, c, grid, int(prof is not None),
                     int(x.dtype == torch.bfloat16))
        return out


KERNEL = UpAssembleKernel()


def assemble(phases: Sequence[Taps], prof: Optional[Taps],
             grid: int) -> torch.Tensor:
    """The stage's even grid ``(Z, B, grid m_y, grid m_x, C)`` from its
    phases' z-taps and the bias profile's (None at stage 1): the plain
    version (:func:`assemble_plain`) on the CPU, the kernel on the card."""
    if phases[0].mid.device.type == "cpu":
        return assemble_plain(phases, prof, grid)
    return KERNEL(phases, prof, grid)
