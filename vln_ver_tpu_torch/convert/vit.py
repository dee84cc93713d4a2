"""Carry ViT weights into the port's :class:`~vln_ver_tpu_torch.models.vit.ViT`.

* :func:`vit_state_dict_from_jax` maps the JAX ViT's flax parameters
  (``vln_ver_tpu/models/vit.py``), as numpy arrays, onto the port's names,
  which are HuggingFace ``ViTModel``'s: the patch kernel (kh, kw, 3, C)
  to the Conv2d weight (C, 3, kh, kw), the attention's per-head q/k/v
  (C, heads, hd) and output (heads, hd, C) kernels to Linear weights, Dense
  kernels transposed, LayerNorm ``scale`` to ``weight``.
* :func:`load_hf_vit_state_dict` loads an HF ``ViTModel`` state dict (for
  instance an ImageNet-pretrained ViT-B/16), strictly, after stripping a
  key prefix such as ``"vit."`` and dropping the pooler: the counterpart of
  the JAX package's ``convert_hf_vit_params`` (``vit.py:147-202``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn


def vit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ViT state dict from the JAX ViT's parameters (the
    ``"params"`` collection, or the variables dict that holds it)."""
    if "params" in params:
        params = params["params"]

    def get(*path):
        a = params
        for k in path:
            a = a[k]
        return np.asarray(a, np.float32)

    def ln(name):
        return {"weight": get(name, "scale"), "bias": get(name, "bias")}

    sd = {
        "embeddings.cls_token": get("cls_token"),
        "embeddings.position_embeddings": get("pos_embed"),
        # flax conv (kh, kw, in, out) -> torch (out, in, kh, kw)
        "embeddings.patch_embeddings.projection.weight":
            get("patch_embed", "kernel").transpose(3, 2, 0, 1),
        "embeddings.patch_embeddings.projection.bias":
            get("patch_embed", "bias"),
    }
    for k, v in ln("final_norm").items():
        sd[f"layernorm.{k}"] = v
    layers = sorted(int(k.split("_")[1]) for k in params
                    if k.startswith("attn_"))
    for i in layers:
        p = f"encoder.layer.{i}."
        attn = params[f"attn_{i}"]
        for name in ("query", "key", "value"):
            kernel = np.asarray(attn[name]["kernel"], np.float32)
            c = kernel.shape[0]
            sd[p + f"attention.attention.{name}.weight"] = \
                kernel.reshape(c, -1).T
            sd[p + f"attention.attention.{name}.bias"] = np.asarray(
                attn[name]["bias"], np.float32).reshape(-1)
        out = np.asarray(attn["out"]["kernel"], np.float32)
        sd[p + "attention.output.dense.weight"] = \
            out.reshape(-1, out.shape[-1]).T
        sd[p + "attention.output.dense.bias"] = np.asarray(
            attn["out"]["bias"], np.float32)
        for ours, theirs in (("layernorm_before", f"ln1_{i}"),
                             ("layernorm_after", f"ln2_{i}")):
            for k, v in ln(theirs).items():
                sd[p + f"{ours}.{k}"] = v
        for ours, theirs in (("intermediate.dense", f"fc1_{i}"),
                             ("output.dense", f"fc2_{i}")):
            sd[p + f"{ours}.weight"] = get(theirs, "kernel").T
            sd[p + f"{ours}.bias"] = get(theirs, "bias")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def load_hf_vit_state_dict(model: nn.Module, state_dict: Mapping,
                           prefix: str = "") -> List[str]:
    """Load an HF ``ViTModel`` state dict into ``model`` by name, strictly:
    keys are taken with ``prefix`` stripped (keys without it are ignored,
    as a classification checkpoint's head is), the pooler is dropped, and
    every parameter of ``model`` must be found.  Values may be tensors or
    numpy arrays.  Returns the keys left unused."""
    sd, unused = {}, []
    for k, v in state_dict.items():
        name = k[len(prefix):] if k.startswith(prefix) else None
        if name is None or name.startswith("pooler."):
            unused.append(k)
            continue
        sd[name] = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).float()
    model.load_state_dict(sd, strict=True)
    return unused
