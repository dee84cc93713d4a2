"""Carry the JAX VLN policy's weights into the port's
:class:`~vln_ver_tpu_torch.agent.policy.VLNPolicy`, and the JAX pretrain
model's (the ``policy`` subtree plus the MLM head) into
:class:`~vln_ver_tpu_torch.agent.pretrain.VLNPretrainModel`.

The port keeps flax's module names, so a flax leaf ``a/b/leaf`` lands on
``a.b.<name>`` with one rule per leaf kind:

* ``kernel`` — a Dense kernel (in, out) transposed to the (out, in)
  weight; an attention ``query``/``key``/``value`` kernel (C, heads,
  head_dim) flattened to (C, heads*head_dim) and transposed; an attention
  ``out`` kernel (heads, head_dim, C) flattened to (heads*head_dim, C) and
  transposed;
* ``bias`` — flattened (an attention bias is (heads, head_dim));
* ``scale`` (LayerNorm) and ``embedding`` (``nn.Embed``) — ``weight``;
* a raw parameter (``pos_embed``, ``stop_token``, ...) — its own name.

Every JAX leaf is used exactly once and every port parameter filled: a
leftover on either side raises, as does a shape that does not fit.  The
policy's ``ground_proj`` is taken when the JAX tree has one (a policy
initialised with REVERIE objects); the JAX tree has no ``fuse_gate``,
and neither has the port.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from torch import nn

from ..agent.policy import PolicyConfig, VLNPolicy
from ..agent.pretrain import VLNPretrainModel


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.array(v, np.float32)  # a writable copy
    return out


def _leaf(path: tuple, arr: np.ndarray):
    """(port name, array) of one flax leaf."""
    *mods, leaf = path
    parent = mods[-1] if mods else None
    if leaf == "kernel":
        if parent in ("query", "key", "value"):
            arr = arr.reshape(arr.shape[0], -1).T
        elif parent == "out" and arr.ndim == 3:
            arr = arr.reshape(-1, arr.shape[-1]).T
        else:
            arr = arr.T
        return ".".join(mods + ["weight"]), arr
    if leaf == "bias":
        return ".".join(mods + ["bias"]), arr.reshape(-1)
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), arr
    return ".".join(path), arr


def policy_state_dict_from_jax(params: Mapping,
                               cfg: PolicyConfig) -> Dict[str, torch.Tensor]:
    """The port's policy state dict from the JAX ``VLNPolicy``'s parameters
    (the ``"params"`` collection, or the variables dict that holds it), as
    numpy arrays.  Load it into ``VLNPolicy(cfg, grounding="ground_proj"
    in params)``."""
    if "params" in params:
        params = params["params"]
    with torch.device("meta"):
        port = VLNPolicy(cfg, grounding="ground_proj" in params)
    return _state_dict_from_tree(params, port)


def pretrain_state_dict_from_jax(params: Mapping, cfg: PolicyConfig
                                 ) -> Dict[str, torch.Tensor]:
    """The port's ``VLNPretrainModel`` state dict from the JAX
    ``VLNPretrainModel``'s parameters (its ``policy`` subtree and the
    ``mlm_cross``, ``mlm_ln``, ``mlm_dense``, ``mlm_ln2`` and ``mlm_out``
    head), by the same rules, strict both ways.  Load it into
    ``VLNPretrainModel(cfg, grounding="ground_proj" in
    params["policy"])``."""
    if "params" in params:
        params = params["params"]
    with torch.device("meta"):
        port = VLNPretrainModel(
            cfg, grounding="ground_proj" in params["policy"])
    return _state_dict_from_tree(params, port)


def _state_dict_from_tree(params: Mapping,
                          port: nn.Module) -> Dict[str, torch.Tensor]:
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    sd = {}
    for path, arr in _flatten(params).items():
        name, arr = _leaf(path, arr)
        if name not in want:
            raise KeyError(f"JAX leaf {'/'.join(path)} -> {name}: no such "
                           "parameter in the port")
        if name in sd:
            raise KeyError(f"two JAX leaves map to {name}")
        if tuple(arr.shape) != want[name]:
            raise ValueError(f"JAX leaf {'/'.join(path)}: shape "
                             f"{arr.shape} -> {name} {want[name]}")
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")
    return sd
