"""flax ``nn.MultiHeadDotProductAttention`` in PyTorch, as the agent uses it
(``qkv_features = out_features = C``), with its attention dropout.

Parameters keep flax's module names, ``query``, ``key``, ``value`` and
``out``, as :class:`~vln_ver_tpu_torch.models.layers.Dense` layers; flax's
per-head kernels (``(C, heads, head_dim)`` in, ``(heads, head_dim, C)``
out) flatten onto their (out, in) weights in
:func:`vln_ver_tpu_torch.convert.policy_state_dict_from_jax`.

The mask follows flax, not ``scaled_dot_product_attention``: masked scores
are set to ``finfo(dtype).min``, so a query row whose keys are all masked
(an invalid memory node in the global blocks) averages every value
uniformly and stays finite, where ``-inf`` would give NaN.

Dropout, active in ``train()`` and the identity in ``eval()``, is flax's
default ``broadcast_dropout=True``: it falls on the attention *weights*
after the softmax, with one keep mask of shape ``(Lq, Lk)`` shared by every
batch row and head, scaled by ``1 / keep``.  An ``nn.Dropout`` on the
``(B, heads, Lq, Lk)`` weights would draw another distribution.  The mask
comes from the default generator of the weights' device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..models.layers import Dense


class MultiHeadAttention(nn.Module):
    def __init__(self, dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        if dims % num_heads:
            raise ValueError(f"embed dims {dims} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.query = Dense(dims, dims, dtype)
        self.key = Dense(dims, dims, dtype)
        self.value = Dense(dims, dims, dtype)
        self.out = Dense(dims, dims, dtype)

    def forward(self, inputs_q: torch.Tensor,
                inputs_k: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs_q (B, Lq, C); inputs_k (B, Lk, C), default ``inputs_q``,
        also the values (flax's ``inputs_v`` defaults to ``inputs_k``);
        mask broadcastable to (B, heads, Lq, Lk), True = attend."""
        if inputs_k is None:
            inputs_k = inputs_q
        b, lq, c = inputs_q.shape
        lk = inputs_k.shape[1]
        h = self.num_heads
        d = c // h
        q = self.query(inputs_q).view(b, lq, h, d).transpose(1, 2)
        k = self.key(inputs_k).view(b, lk, h, d).transpose(1, 2)
        v = self.value(inputs_k).view(b, lk, h, d).transpose(1, 2)
        # flax scales the query before the product
        scores = (q / math.sqrt(d)) @ k.transpose(-1, -2)   # (B, h, Lq, Lk)
        if mask is not None:
            scores = torch.where(mask, scores,
                                 torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        if self.training and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(weights.shape[-2:], device=weights.device) < keep
            weights = weights * (mask.to(weights.dtype) / keep)
        y = (weights @ v).transpose(1, 2).reshape(b, lq, c)
        return self.out(y)
