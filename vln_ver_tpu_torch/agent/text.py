"""Instruction encoder: a compact BERT-style transformer (PyTorch port of
``vln_ver_tpu/agent/text.py``).

Two architectures:

* ``arch="preln"`` (default) — pre-LN transformer with a final norm; its
  GELU is flax's default tanh approximation.
* ``arch="bert"`` — HuggingFace ``BertModel`` encoder layout (post-LN
  blocks, token-type embedding of segment 0, no final norm), exact GELU.

Every LayerNorm has flax's eps, 1e-6.  Module names are the flax ones, so
the JAX parameters map one to one
(:func:`vln_ver_tpu_torch.convert.policy_state_dict_from_jax`), and
:func:`convert_hf_bert_params` maps a HuggingFace ``BertModel`` state dict
onto ``arch="bert"``.

Dropout sits at the JAX module's places, active in ``train()``: after the
embedding norm, on every attention's weights, and on each sublayer's
output before its residual (``bert``: both sublayers; ``preln``: the FFN's
alone, none on the attention residual).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense, LayerNorm
from .attention import MultiHeadAttention


class TextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 4000, embed_dims: int = 768,
                 num_layers: int = 4, num_heads: int = 8,
                 ffn_dim: int = 1536, max_len: int = 80,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, arch: str = "preln"):
        super().__init__()
        if arch not in ("preln", "bert"):
            raise ValueError(f"text arch {arch!r}: 'preln' or 'bert'")
        self.arch = arch
        self.num_layers = num_layers
        self.dtype = dtype
        self.token_embed = nn.Embedding(vocab_size, embed_dims)
        self.pos_embed = nn.Parameter(torch.empty(max_len, embed_dims))
        if arch == "bert":
            self.type_embed = nn.Parameter(torch.empty(2, embed_dims))
        self.embed_norm = LayerNorm(embed_dims, dtype)
        self.dropout = nn.Dropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(embed_dims, dtype))
            self.add_module(f"attn_{i}", MultiHeadAttention(
                embed_dims, num_heads, dtype, dropout_rate))
            self.add_module(f"ln2_{i}", LayerNorm(embed_dims, dtype))
            self.add_module(f"fc1_{i}", Dense(embed_dims, ffn_dim, dtype))
            self.add_module(f"fc2_{i}", Dense(ffn_dim, embed_dims, dtype))
        if arch == "preln":
            self.final_norm = LayerNorm(embed_dims, dtype)

    def forward(self, tokens: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) int; mask (B, L) bool (True = real token).
        Returns (B, L, C)."""
        l = tokens.shape[1]
        x = (self.token_embed(tokens.long()).to(self.dtype)
             + self.pos_embed[None, :l].to(self.dtype))
        if self.arch == "bert":
            x = x + self.type_embed[0].to(self.dtype)
        x = self.dropout(self.embed_norm(x))
        attn_mask = mask[:, None, None, :]  # (B, 1, 1, L)
        drop = self.dropout
        for i in range(self.num_layers):
            attn = getattr(self, f"attn_{i}")
            ln1, ln2 = getattr(self, f"ln1_{i}"), getattr(self, f"ln2_{i}")
            fc1, fc2 = getattr(self, f"fc1_{i}"), getattr(self, f"fc2_{i}")
            if self.arch == "preln":
                y = ln1(x)
                x = x + attn(y, y, attn_mask)
                x = x + drop(fc2(F.gelu(fc1(ln2(x)), approximate="tanh")))
            else:  # post-LN, HF BertLayer order
                x = ln1(x + drop(attn(x, x, attn_mask)))
                x = ln2(x + drop(fc2(F.gelu(fc1(x)))))
        if self.arch == "preln":
            x = self.final_norm(x)
        return x


def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                      else v, np.float32)


def convert_hf_bert_params(state_dict: Mapping, num_layers: int,
                           num_heads: int,
                           prefix: str = "") -> Dict[str, torch.Tensor]:
    """Map a HuggingFace ``BertModel`` state dict (torch tensors or numpy
    arrays; keys may carry a ``prefix`` such as ``"bert."``) onto the state
    dict of ``TextEncoder(arch="bert")``, the counterpart of
    ``vln_ver_tpu.agent.text.convert_hf_bert_params``.  Both sides keep
    torch's (out, in) weights, so every tensor is carried as it is.  The
    BERT pooler is dropped (the policy consumes token features, not the
    pooled CLS); a missing key raises ``KeyError``."""
    def get(name):
        return torch.from_numpy(_np(state_dict[prefix + name]).copy())

    hidden = get("embeddings.word_embeddings.weight").shape[1]
    if hidden % num_heads:
        raise ValueError(f"hidden {hidden} not divisible by {num_heads} "
                         "heads")
    sd = {"token_embed.weight": get("embeddings.word_embeddings.weight"),
          "pos_embed": get("embeddings.position_embeddings.weight"),
          "type_embed": get("embeddings.token_type_embeddings.weight"),
          "embed_norm.weight": get("embeddings.LayerNorm.weight"),
          "embed_norm.bias": get("embeddings.LayerNorm.bias")}
    for i in range(num_layers):
        pre = f"encoder.layer.{i}."
        for ours, theirs in (
                (f"attn_{i}.query", "attention.self.query"),
                (f"attn_{i}.key", "attention.self.key"),
                (f"attn_{i}.value", "attention.self.value"),
                (f"attn_{i}.out", "attention.output.dense"),
                (f"ln1_{i}", "attention.output.LayerNorm"),
                (f"fc1_{i}", "intermediate.dense"),
                (f"fc2_{i}", "output.dense"),
                (f"ln2_{i}", "output.LayerNorm")):
            for leaf in ("weight", "bias"):
                sd[f"{ours}.{leaf}"] = get(f"{pre}{theirs}.{leaf}")
    return sd
