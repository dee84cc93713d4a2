"""Carry BEVFormer-2D weights from the JAX package into the port.

:func:`bev2d_state_dict_from_jax` maps a JAX ``BEVFormer2D`` parameter
tree (numpy leaves) onto the port's names (``models/bev2d.py``): the
encoder and decoder layers' ``attentions.{0,1}``, ``norms.{0,1,2}`` and
``ffns.0``, the can-bus MLP's ``0``, ``2`` and ``norm``, the class and
regression branches' Sequential indices.  The load is strict both ways: a
leaf of the tree the port has no parameter for, or a parameter the tree
lacks, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..models.bev2d import BEV2DConfig
from .voxelformer import KeyMap, _flatten


def _mapping(cfg: BEV2DConfig) -> KeyMap:
    m = KeyMap()
    t = "transformer"
    m.leaf("bev_embedding", "bev_embedding.weight")
    m.leaf("query_embedding", "query_embedding.weight")
    for name in ("row_embed", "col_embed"):
        m.leaf(f"positional_encoding/{name}",
               f"positional_encoding.{name}.weight")
    m.leaf(f"{t}/level_embeds", f"{t}.level_embeds")
    m.leaf(f"{t}/cams_embeds", f"{t}.cams_embeds")
    m.lin(f"{t}/input_proj", f"{t}.input_proj")
    if cfg.use_can_bus:
        m.lin(f"{t}/can_bus_mlp/layers_0", f"{t}.can_bus_mlp.0")
        m.lin(f"{t}/can_bus_mlp/layers_2", f"{t}.can_bus_mlp.2")
        if cfg.can_bus_norm:
            m.ln(f"{t}/can_bus_mlp/layers_4", f"{t}.can_bus_mlp.norm")
    m.lin(f"{t}/reference_points", f"{t}.reference_points")
    deform = ("value_proj", "sampling_offsets", "attention_weights")
    for i in range(cfg.encoder_layers):
        jl, el = f"{t}/encoder/layer_{i}", f"{t}.encoder.layers.{i}"
        for name in deform + ("output_proj",):
            m.lin(f"{jl}/temporal_self_attn/{name}",
                  f"{el}.attentions.0.{name}")
        for name in deform:
            m.lin(f"{jl}/cross_attn/deformable_attention/{name}",
                  f"{el}.attentions.1.deformable_attention.{name}")
        m.lin(f"{jl}/cross_attn/output_proj", f"{el}.attentions.1.output_proj")
        m.ffn(f"{jl}/ffn", f"{el}.ffns.0")
        for j in range(3):
            m.ln(f"{jl}/norm{j + 1}", f"{el}.norms.{j}")
    for i in range(cfg.decoder_layers):
        jd, dl = f"{t}/decoder", f"{t}.decoder.layers.{i}"
        m.mha(f"{jd}/self_attn_{i}", f"{dl}.attentions.0")
        for name in deform + ("output_proj",):
            m.lin(f"{jd}/cross_attn_{i}/{name}", f"{dl}.attentions.1.{name}")
        m.ffn(f"{jd}/ffn_{i}", f"{dl}.ffns.0")
        for j in range(3):
            m.ln(f"{jd}/norm{j + 1}_{i}", f"{dl}.norms.{j}")
        m.seq(f"cls_branch_{i}", f"cls_branches.{i}", 2, with_ln=True)
        for j in (0, 2, 4):
            m.lin(f"reg_branches_{i}/layers_{j}", f"reg_branches.{i}.{j}")
    return m


def bev2d_state_dict_from_jax(params: Mapping, cfg: BEV2DConfig
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``BEVFormer2D`` parameter tree (numpy leaves; an outer
    ``{"params": ...}`` is unwrapped) -> the port's state_dict.  Raises
    KeyError on a leaf the mapping does not use and on a parameter the
    tree lacks."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    sd, unmapped = _mapping(cfg).convert(_flatten(params))
    if unmapped:
        raise KeyError(f"JAX params have leaves the port's BEVFormer2D has "
                       f"no parameter for: {unmapped[:10]}")
    return sd
