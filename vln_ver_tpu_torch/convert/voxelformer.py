"""Carry VoxelFormer weights into the port.

The port's modules use the reference ``state_dict`` names, which are also
what the JAX package's ``export_state_dict`` writes and what
``tools/export_voxelformer.py`` saves as a ``.pth``.  Two ways in:

* :func:`state_dict_from_jax` maps a JAX (flax) parameter tree of numpy
  arrays straight onto those names, for every leaf of a VoxelFormer:
  Linear kernels transposed, LayerNorm ``scale`` to ``weight``, the
  self-attention's per-projection q/k/v kernels packed into
  ``in_proj_weight`` / ``in_proj_bias``, and the upsampler's correlation
  kernels flipped and transposed into ``ConvTranspose3d`` weights.  A
  temporal (TSA) config's encoder layers take the reference's temporal
  numbering: ``attentions.0`` the TSA, ``attentions.1`` the SCA and
  ``norms.{0,1,2}`` (JAX ``norm0``, ``norm1``, ``norm2``); the JAX
  package's own ``export_state_dict`` refuses those configs.
* :func:`load_checkpoint` loads a reference-format ``.pth`` by name,
  strictly.

:func:`train_state_from_jax` carries a JAX train state across: the
parameters and the AdamW moments, both through the same leaf mapping.
Every map there is a reshape, transpose, flip or concatenation, a
permutation of elements, so the moments map exactly, and so do gradients.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models.config import VERConfig
from ..models.head import upsampler_stages

# keys of a reference checkpoint with no forward semantics on the active
# path: the dead image backbone and neck (the dataset supplies ViT
# features, voxelformer.py:282-289) and a loss buffer
_DEAD_PREFIXES = ("img_backbone.", "img_neck.")
_DEAD_KEYS = ("pts_bbox_head.code_weights",)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _same(a):
    return a


def _transpose(a):
    return a.T


def _pack_qkv_kernels(q, k, v):
    """flax (E, H, D) q/k/v kernels -> torch ``in_proj_weight`` (3E, E)."""
    return np.concatenate([w.reshape(w.shape[0], -1).T for w in (q, k, v)])


def _pack_qkv_biases(q, k, v):
    return np.concatenate([b.reshape(-1) for b in (q, k, v)])


def _mha_out_kernel(k):
    """flax (H, D, E) output kernel -> torch (E, E) ``out_proj.weight``."""
    return k.reshape(-1, k.shape[-1]).T


def _conv_transpose_kernel(k):
    """Correlation kernel (kD, kH, kW, in, out) -> ConvTranspose3d weight
    (in, out, kD, kH, kW): a transposed convolution is the correlation
    with the spatially flipped kernel."""
    return k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)


class KeyMap(dict):
    """The port's state_dict key -> (the JAX leaf paths it is made of,
    numpy transform of those leaves), filled by the helpers below for
    flax's Dense, LayerNorm, branch and attention modules."""

    def leaf(self, jax_path: str, key: str, fn: Callable = _same) -> None:
        self[key] = ((jax_path,), fn)

    def lin(self, jax_path: str, key: str) -> None:
        self.leaf(f"{jax_path}/kernel", f"{key}.weight", _transpose)
        self.leaf(f"{jax_path}/bias", f"{key}.bias")

    def ln(self, jax_path: str, key: str) -> None:
        self.leaf(f"{jax_path}/scale", f"{key}.weight")
        self.leaf(f"{jax_path}/bias", f"{key}.bias")

    def seq(self, jax_path: str, key: str, num_fcs: int,
            with_ln: bool) -> None:
        """A class (``with_ln``) or regression branch: flax ``fc{i}``,
        ``ln{i}``, ``out`` -> torch Sequential indices."""
        step = 3 if with_ln else 2
        for i in range(num_fcs):
            self.lin(f"{jax_path}/fc{i}", f"{key}.{step * i}")
            if with_ln:
                self.ln(f"{jax_path}/ln{i}", f"{key}.{step * i + 1}")
        self.lin(f"{jax_path}/out", f"{key}.{step * num_fcs}")

    def mha(self, jax_path: str, key: str) -> None:
        qkv = tuple(f"{jax_path}/attn/{n}" for n in ("query", "key", "value"))
        self[f"{key}.attn.in_proj_weight"] = (
            tuple(f"{p}/kernel" for p in qkv), _pack_qkv_kernels)
        self[f"{key}.attn.in_proj_bias"] = (
            tuple(f"{p}/bias" for p in qkv), _pack_qkv_biases)
        self.leaf(f"{jax_path}/attn/out/kernel",
                  f"{key}.attn.out_proj.weight", _mha_out_kernel)
        self.leaf(f"{jax_path}/attn/out/bias", f"{key}.attn.out_proj.bias")

    def ffn(self, jax_path: str, key: str) -> None:
        self.lin(f"{jax_path}/fc1", f"{key}.layers.0.0")
        self.lin(f"{jax_path}/fc2", f"{key}.layers.1")

    def convert(self, leaves: Mapping[str, np.ndarray]
                ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
        """(state_dict, the leaf paths not mapped); raises KeyError where
        a leaf of the mapping is missing."""
        needed = {p for paths, _ in self.values() for p in paths}
        missing = sorted(needed - set(leaves))
        if missing:
            raise KeyError(f"JAX params lack leaves of the model: "
                           f"{missing[:10]}")
        sd = {key: torch.from_numpy(np.ascontiguousarray(
                  fn(*(leaves[p] for p in paths)), dtype=np.float32))
              for key, (paths, fn) in self.items()}
        return sd, sorted(set(leaves) - needed)


def _mapping(cfg: VERConfig) -> KeyMap:
    """The mapping of every parameter of the model ``cfg`` builds."""
    h, t = "pts_bbox_head", "pts_bbox_head.transformer"
    m = KeyMap()
    leaf, lin, ln, seq, mha = m.leaf, m.lin, m.ln, m.seq, m.mha

    leaf(f"{h}/voxel_embedding", f"{h}.voxel_embedding.weight")
    for name in ("row_embed", "col_embed", "z_embed"):
        leaf(f"{h}/positional_encoding/{name}",
             f"{h}.positional_encoding.{name}.weight")
    leaf(f"{h}/transformer/cams_embeds", f"{t}.cams_embeds")
    leaf(f"{h}/transformer/level_embeds", f"{t}.level_embeds")
    # the reference numbers a temporal layer's attentions and norms in its
    # operation order (self_attn, norm, cross_attn, norm, ffn, norm)
    tsa = int(cfg.use_temporal_self_attn)
    for i in range(cfg.encoder_layers):
        jl = f"{h}/transformer/encoder/layer_{i}"
        el = f"{t}.encoder.layers.{i}"
        if tsa:
            for name in ("value_proj", "sampling_offsets",
                         "attention_weights", "output_proj"):
                lin(f"{jl}/temporal_self_attn/{name}",
                    f"{el}.attentions.0.{name}")
            ln(f"{jl}/norm0", f"{el}.norms.0")
        sca = f"{el}.attentions.{tsa}"
        for name in ("value_proj", "sampling_offsets", "attention_weights"):
            lin(f"{jl}/cross_attn/deformable_attention/{name}",
                f"{sca}.deformable_attention.{name}")
        lin(f"{jl}/cross_attn/output_proj", f"{sca}.output_proj")
        ln(f"{jl}/norm1", f"{el}.norms.{tsa}")
        m.ffn(f"{jl}/ffn", f"{el}.ffns.0")
        ln(f"{jl}/norm2", f"{el}.norms.{tsa + 1}")

    if not cfg.only_occ:
        leaf(f"{h}/query_embedding", f"{h}.query_embedding.weight")
        leaf(f"{h}/query_layout_embedding",
             f"{h}.query_layout_embedding.weight")
        lin(f"{h}/transformer/reference_points", f"{t}.reference_points")
        if cfg.decoder_on_bev and cfg.voxel_2_bev_type == "mlp":
            for j, kind in ((0, lin), (1, ln), (3, lin), (4, ln)):
                kind(f"{h}/transformer/voxel2bev/layers_{j}",
                     f"{t}.voxel2bev.{j}")
        for i in range(cfg.decoder_layers):
            jl = f"{h}/transformer/decoder/layer_{i}"
            dl = f"{t}.decoder.layers.{i}"
            mha(f"{jl}/self_attn", f"{dl}.attentions.0")
            ln(f"{jl}/norm1", f"{dl}.norms.0")
            for name in ("value_proj", "sampling_offsets",
                         "attention_weights", "output_proj"):
                lin(f"{jl}/cross_attn/{name}", f"{dl}.attentions.1.{name}")
            ln(f"{jl}/norm2", f"{dl}.norms.1")
            m.ffn(f"{jl}/ffn", f"{dl}.ffns.0")
            ln(f"{jl}/norm3", f"{dl}.norms.2")
            # the reference keeps the regression branches on the head
            seq(f"{h}/transformer/reg_branch_{i}", f"{h}.reg_branches.{i}",
                cfg.num_reg_fcs, with_ln=False)
            seq(f"{h}/cls_branch_{i}", f"{h}.cls_branches.{i}",
                cfg.num_reg_fcs, with_ln=True)
            if cfg.predicts_layout:
                seq(f"{h}/layout_branch_{i}", f"{h}.layout_branches.{i}",
                    cfg.num_reg_fcs, with_ln=False)

    if not cfg.only_det:
        lin(f"{h}/occ_proj", f"{h}.occ_proj")
        seq(f"{h}/occ_branches", f"{h}.occ_branches", cfg.num_occ_fcs,
            with_ln=True)
        if cfg.refine_occ:
            for i in range(upsampler_stages(cfg)):
                leaf(f"{h}/up_sample/up{i}/kernel",
                     f"{h}.up_sample.{i}.weight", _conv_transpose_kernel)
                leaf(f"{h}/up_sample/up{i}/bias", f"{h}.up_sample.{i}.bias")
    return m


def state_dict_from_jax(params: Mapping, cfg: VERConfig
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX ``VoxelFormer`` parameter tree (numpy leaves; an outer
    ``{"params": ...}`` is unwrapped) -> (the port's state_dict, the JAX
    leaf paths it did not map, empty for a model of the tree's config).

    The positional encoding is inert without TSA, so flax creates it only
    for a temporal config; where the tree lacks it, it gets zeros of the
    reference shapes, as the JAX package's ``export_state_dict`` writes.
    Raises KeyError when any other parameter of the model is missing."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    leaves = _flatten(params)
    pos = "pts_bbox_head/positional_encoding/"
    for name, rows in (("row_embed", cfg.bev_h), ("col_embed", cfg.bev_w),
                       ("z_embed", cfg.bev_z)):
        leaves.setdefault(pos + name, np.zeros((rows, cfg.embed_dims),
                                               np.float32))
    return _mapping(cfg).convert(leaves)


def load_checkpoint(model: nn.Module, path: str) -> List[str]:
    """Load a reference-format ``.pth`` (a state_dict, or mmcv's
    ``{"state_dict": ..., "meta": ...}``) into ``model`` by name,
    strictly: a parameter of the model missing from the file, or a key of
    the file the model has no parameter for, is an error.  The keys it
    ignores, and returns, are the reference's dead image backbone and loss
    buffer and, where the model has none (``add_layout`` off, or
    ``only_det``), its always-built ``layout_branches``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    layout = "pts_bbox_head.layout_branches."

    def ignored(k: str) -> bool:
        return (k.startswith(_DEAD_PREFIXES) or k in _DEAD_KEYS
                or "num_batches_tracked" in k
                or (k.startswith(layout) and not model.cfg.predicts_layout))

    skip = sorted(k for k in sd if ignored(k))
    res = model.load_state_dict({k: v for k, v in sd.items()
                                 if k not in skip}, strict=False)
    if res.missing_keys:
        raise KeyError(f"{path} lacks parameters of the model: "
                       f"{res.missing_keys[:10]}")
    if res.unexpected_keys:
        raise KeyError(f"{path} has keys the model has no parameter for: "
                       f"{res.unexpected_keys[:10]}")
    return skip


def _adam_state(opt_state: Any):
    """The node of an optax state that holds AdamW's ``count``, ``mu`` and
    ``nu`` (``ScaleByAdamState`` in the chain, or the fused state)."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        for child in opt_state:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def train_state_from_jax(params: Mapping, opt_state: Any, cfg: VERConfig,
                         tc=None, device="cpu"):
    """A JAX train state (a parameter tree and its optax AdamW state, numpy
    or JAX array leaves) -> the port's
    :class:`~vln_ver_tpu_torch.train.TrainState` on ``device``, with
    ``exp_avg`` / ``exp_avg_sq`` from ``mu`` / ``nu`` and the step count
    from the optimizer's update count, so the next update takes the
    schedule's next lr.  Parameters the tree lacks (the inert positional
    encoding) start with zero moments."""
    from ..models.detector import VoxelFormer
    from ..train.state import TrainConfig, create_train_state

    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no AdamW state (count, mu, nu) in opt_state")
    sd, _ = state_dict_from_jax(params, cfg)
    mu, _ = state_dict_from_jax(adam.mu, cfg)
    nu, _ = state_dict_from_jax(adam.nu, cfg)
    count = int(np.asarray(adam.count))
    model = VoxelFormer(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(device)
    tc = tc or TrainConfig()
    state = create_train_state(model, tc)
    for name, p in model.named_parameters():
        step_dev = p.device if tc.fused_opt else "cpu"
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), device=step_dev),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device)}
    state.step = count
    return state
