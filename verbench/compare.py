"""How the benchmark compares the program with the plain reference, and
the control's lower precision.

``spread_error(got, ref)``: the RMS of ``got - ref`` over the RMS of
``ref`` about its mean, in float64: an error relative to the reference's
own spread, so that a constant offset (the class branches' focal-prior
bias) neither hides nor inflates it.

``control_precision(dtype)``: the control's precision, the nearest below
the configuration's: ``fp8`` for bf16, where ``quantizer('fp8')`` rounds
both operands of every matrix product and convolution of the reference
through ``float8_e4m3fn`` with one scale a tensor (absmax to 448); and
``tf32`` for fp32, where the reference runs with TF32 on.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def spread_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.detach().double()
    diff = got.detach().double() - ref
    scale = (ref - ref.mean()).pow(2).mean().sqrt().clamp_min(1e-300)
    return float(diff.pow(2).mean().sqrt() / scale)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def quantizer(name: str) -> Callable:
    if name != "fp8":
        raise ValueError(f"no rounding for the control {name!r}")
    return _fp8


def control_precision(dtype: str) -> str:
    """The nearest precision below the one a configuration states."""
    return {"bfloat16": "fp8", "float16": "fp8", "float32": "tf32"}[dtype]


def judge(numbers: List[Dict]) -> bool:
    """Every number within its limit."""
    return all(n["value"] == n["value"] and n["value"] <= n["limit"]
               for n in numbers)
