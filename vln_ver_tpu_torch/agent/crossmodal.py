"""DUET / LXMERT cross-modal pretrained weights onto the policy's fusion
blocks (PyTorch port of ``vln_ver_tpu/agent/crossmodal.py``).

A DUET / HAMT agent inherits a BERT text encoder (``text.
convert_hf_bert_params``) and *cross-modal x-layers*: LXMERT blocks whose
vision stream cross-attends the instruction, self-attends and runs an
FFN, each with a post-LN residual.  ``_FusionBlock(fusion_arch="bert")``
has that layout, so a torch state dict carries over function for
function.

Key schema accepted (DUET ``vilmodel.py`` LXRTXLayer / HF
``LxmertXLayer``), per layer under ``{prefix}x_layers.{i}.``::

    crossattention.att.{query,key,value}.{weight,bias}   (or .self.)
    crossattention.output.{dense.{weight,bias},LayerNorm.{weight,bias}}
    visn_self_att.self.{query,key,value}.{weight,bias}
    visn_self_att.output.{dense,LayerNorm}...
    visn_inter.dense.{weight,bias}
    visn_output.{dense,LayerNorm}...

HF LXMERT's ``visual_attention.att`` alias is taken too; the language
stream's halves (``lang_self_att`` and the rest) are ignored: the policy's
fusion blocks are one-directional, as DUET's are.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch

from .text import _np

__all__ = ["detect_x_layers", "convert_crossmodal_params"]


def detect_x_layers(state_dict: Mapping,
                    prefix_hint: Optional[str] = None) -> Dict[str, int]:
    """The cross-modal stacks of a state dict: {prefix: number of layers}.
    A prefix is everything before ``x_layers.N.`` (DUET has two stacks,
    ``global_encoder.`` and ``local_encoder.``; HF LXMERT one,
    ``lxmert.encoder.``)."""
    pat = re.compile(r"^(.*?)x_layers\.(\d+)\.")
    stacks: Dict[str, int] = {}
    for k in state_dict:
        m = pat.match(k)
        if m and (prefix_hint is None or m.group(1).startswith(prefix_hint)):
            p = m.group(1)
            stacks[p] = max(stacks.get(p, 0), int(m.group(2)) + 1)
    return stacks


def convert_crossmodal_params(state_dict: Mapping, num_layers: int,
                              num_heads: int, prefix: str = ""
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """One x-layer stack -> ``{"block_i": state dict of
    _FusionBlock(fusion_arch="bert")}``, for the caller to load into
    ``local_block_i`` / ``global_block_i``.  Both sides keep torch's (out,
    in) weights, so every tensor is carried as it is.  A missing key
    raises ``KeyError`` (no partial graft)."""
    def get(name):
        for cand in (name,
                     name.replace("crossattention.att.",
                                  "crossattention.self."),
                     name.replace("crossattention.", "visual_attention.")):
            if prefix + cand in state_dict:
                return torch.from_numpy(_np(state_dict[prefix + cand]).copy())
        raise KeyError(f"{prefix + name} (tried crossattention.att/.self "
                       "and visual_attention.* aliases)")

    hidden = get("x_layers.0.crossattention.att.query.weight").shape[1]
    if hidden % num_heads:
        raise ValueError(f"hidden {hidden} not divisible by {num_heads} "
                         "heads")

    blocks: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in range(num_layers):
        pre = f"x_layers.{i}."
        pairs = []
        for ours, ln, qkv, out in (
                ("cross_attn", "ln_ca", "crossattention.att",
                 "crossattention.output"),
                ("self_attn", "ln_sa", "visn_self_att.self",
                 "visn_self_att.output")):
            pairs += [(f"{ours}.{p}", f"{qkv}.{p}")
                      for p in ("query", "key", "value")]
            pairs += [(f"{ours}.out", f"{out}.dense"),
                      (ln, f"{out}.LayerNorm")]
        pairs += [("fc1", "visn_inter.dense"), ("fc2", "visn_output.dense"),
                  ("ln_ffn", "visn_output.LayerNorm")]
        blocks[f"block_{i}"] = {
            f"{ours}.{leaf}": get(f"{pre}{theirs}.{leaf}")
            for ours, theirs in pairs for leaf in ("weight", "bias")}
    return blocks
