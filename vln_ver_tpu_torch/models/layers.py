"""Linear, LayerNorm and the upsampler's reference transposed convolution
with the JAX package's dtype semantics.

A flax ``nn.Dense(dtype=...)`` keeps fp32 parameters and computes in its
``dtype``; :class:`Dense` does the same, so one module tree serves fp32
and bf16 compute.  Parameters are created uninitialised and filled by
``reset_parameters(generator)`` with the flax initialisers' distributions
(lecun-normal kernels, zero biases), from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import draw_rows


class Dense(nn.Module):
    """``y = x @ weight.T + bias`` in ``dtype``; weight is (out, in) as in
    torch and the reference state_dict."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.dtype = dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax lecun_normal: truncated normal (2 sigma), variance 1/fan_in
        std = math.sqrt(1.0 / self.weight.shape[1]) / .87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Dropout(nn.Dropout):
    """``nn.Dropout`` (active in ``train()``, scaled by ``1 / keep``) whose
    keep mask is an explicit ``bernoulli_`` draw of the default generator
    of the input's device, made for the whole batch: inside
    ``parallel.mesh.data_parallel`` each rank draws the global batch's mask
    and takes its rows, the mask of the one-process run."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = draw_rows(lambda shape: torch.empty(
            shape, dtype=x.dtype, device=x.device).bernoulli_(keep), x.shape)
        return x * (mask / keep)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6 by default (torch's default is
    1e-5), statistics in fp32, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.dtype)


class ConvTranspose3d(nn.Module):
    """One reference upsampler stage, ``nn.ConvTranspose3d(C, C, (3, 5, 5),
    stride (1, 2, 2), padding (2, 4, 4), dilation 2, output_padding
    (0, 1, 1))`` (vln_ver_tpu/models/head.py:97-98), in ``dtype``, on
    NCDHW tensors.  ``weight`` is torch's ``(in, out, kD, kH, kW)``.

    With stride 2 and dilation 2 every kernel tap lands on an even output
    (y, x): each odd row or column of the output is the bias alone.

    The plain reference of the upsampler: the model runs the same
    parameters through the even-grid factorisation (``head.OccUpsampler``),
    and only the tests and chip_smoke.py run this dense transposed
    convolution (``head.dense_reference``), to hold that against it."""

    kernel = (3, 5, 5)
    stride = (1, 2, 2)
    padding = (2, 4, 4)
    output_padding = (0, 1, 1)
    dilation = (2, 2, 2)

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels,
                                               *self.kernel))
        self.bias = nn.Parameter(torch.empty(channels))
        self.dtype = dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax lecun_normal on the (3, 5, 5, C, C) kernel: fan-in 75 * C
        fan_in = self.weight[:, 0].numel()
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv_transpose3d(
            x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
            self.padding, self.output_padding, 1, self.dilation)
