"""VER volume tokenizer + volume state estimation (PyTorch port of
``vln_ver_tpu/agent/ver.py``).

* ``VERTokenizer`` — compresses the 900-voxel volume (bev_z*bev_h*bev_w x
  C, the artifact ``get_occ`` dumps) into a small token set for
  cross-attention: per-z-slice mean tokens + learned-query pooling with 8
  heads (fixed, as in the JAX module, whatever the policy's head count),
  then a LayerNorm; the pooling attention drops weights in ``train()``.
* ``VolumeStateHead`` — "volume state estimation" (paper §3.4): predicts
  (sin h, cos h, dx, dy, dz) of the agent state from the tokens, in fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.layers import Dense, LayerNorm
from .attention import MultiHeadAttention

POOL_HEADS = 8


class VERTokenizer(nn.Module):
    def __init__(self, embed_dims: int = 768, bev_z: int = 4,
                 bev_h: int = 15, bev_w: int = 15,
                 num_query_tokens: int = 8, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dims = embed_dims
        self.bev_z, self.bev_h, self.bev_w = bev_z, bev_h, bev_w
        self.dtype = dtype
        self.pool_queries = nn.Parameter(
            torch.empty(num_query_tokens, embed_dims))
        self.pool_attn = MultiHeadAttention(embed_dims, POOL_HEADS, dtype,
                                            dropout_rate)
        self.token_norm = LayerNorm(embed_dims, dtype)

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        """volume (B, bev_z*bev_h*bev_w, C) -> tokens
        (B, bev_z + num_query_tokens, C)."""
        b = volume.shape[0]
        vol = volume.reshape(b, self.bev_z, self.bev_h * self.bev_w,
                             self.embed_dims)
        slice_tokens = vol.mean(dim=2)                       # (B, Z, C)
        q = self.pool_queries[None].expand(b, -1, -1).to(self.dtype)
        pooled = self.pool_attn(q, volume.to(self.dtype))
        tokens = torch.cat([slice_tokens.to(self.dtype), pooled], dim=1)
        return self.token_norm(tokens)


class VolumeStateHead(nn.Module):
    def __init__(self, embed_dims: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(embed_dims, embed_dims, dtype)
        # a module, so that utils.params.relu_masks can record and pin it
        self.relu = nn.ReLU()
        self.out = Dense(embed_dims, 5, torch.float32)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.out(self.relu(self.fc1(tokens.mean(dim=1))))
