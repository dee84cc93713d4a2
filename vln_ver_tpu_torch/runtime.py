"""Device selection and numeric settings shared by the entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; asking for CUDA where there is none raises, it never carries
    on on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            "--device cpu to run the plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def set_fp32_precision(dtype: torch.dtype) -> None:
    """In fp32 mode, keep fp32 matmuls and convolutions in full fp32: TF32
    keeps about three decimal digits, and the JAX reference forces HIGHEST
    precision for fp32 (vln_ver_tpu/ops/pallas_deform.py:75-80).  cuDNN
    convolutions default to TF32, so both flags are set explicitly."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def fp32_precision(dtype: torch.dtype):
    """Run the block in true fp32 when ``dtype`` is fp32, whatever the
    caller left in the process-wide TF32 flags (cuDNN's defaults to True),
    and put the flags back after it."""
    if dtype != torch.float32:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    set_fp32_precision(dtype)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
