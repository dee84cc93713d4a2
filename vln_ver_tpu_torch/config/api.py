"""MMDetection3D-style config front-end (PyTorch port).

Loads mmcv-style *Python-file* configs with ``_base_`` inheritance, applies
``--cfg-options`` overrides and maps the nested type-name dicts onto the
port's :class:`VERConfig`.  The reference workloads
(``configs/verformer/get_occ.py``, ``vocc_tiny.py``) are plain dicts and
load unchanged.  Missing ``_base_`` files are skipped with a warning.
"""

from __future__ import annotations

import ast
import os
import warnings
from typing import Any, Dict, List, Optional

import torch

from ..models.config import MP3D_FOCAL_REAL_CLASSES, VERConfig
from ..train.state import TrainConfig


class Config(dict):
    """dict with attribute access, recursively.

    Nested dicts are wrapped IN PLACE on first attribute access, so
    mmcv-style nested mutation (``cfg.model.pts_bbox_head.x = 1``) sticks."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            self[k] = v
        return v

    def __setattr__(self, k, v):
        self[k] = v


def _merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict):
            # consume _delete_ always (mmcv Config semantics) and never
            # mutate the caller's override dict
            v = dict(v)
            delete = bool(v.pop("_delete_", False))
            if k in out and isinstance(out[k], dict) and not delete:
                out[k] = _merge(out[k], v)
            else:
                out[k] = v
        else:
            out[k] = v
    return out


def _exec_py(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    ns: Dict[str, Any] = {}
    exec(compile(src, path, "exec"), ns)
    ns.pop("__builtins__", None)
    return ns


def load_config(path: str) -> Config:
    ns = _exec_py(path)
    bases: List[str] = ns.pop("_base_", []) or []
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for rel in bases:
        bpath = os.path.normpath(os.path.join(os.path.dirname(path), rel))
        if not os.path.exists(bpath):
            warnings.warn(f"_base_ config not found, skipping: {bpath}")
            continue
        merged = _merge(merged, dict(load_config(bpath)))
    merged = _merge(merged, ns)
    return Config(merged)


def apply_cfg_options(cfg: Config, options) -> Config:
    """Apply dotted-key CLI overrides, mmcv ``--cfg-options`` style:
    ``a.b.c=value`` with literal-eval'd values."""
    for opt in options or []:
        key, _, raw = opt.partition("=")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = val
    return cfg


def _get(d: Dict, *keys, default=None):
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def build_ver_config(cfg: Config, **overrides) -> VERConfig:
    """Map an mmcv-style model dict onto VERConfig."""
    model = cfg.get("model", {})
    head = model.get("pts_bbox_head", {})
    tr = head.get("transformer", {})
    enc = tr.get("encoder", {})
    dec = tr.get("decoder", {}) or {}
    enc_layer = enc.get("transformerlayers", {})
    dec_layer = dec.get("transformerlayers", {})
    sca = _get(enc_layer, "attn_cfgs", default=[{}])
    sca = sca[0] if isinstance(sca, list) and sca else {}
    deform = sca.get("deformable_attention", {})
    dec_attns = dec_layer.get("attn_cfgs", []) or []
    dec_mha = dec_attns[0] if len(dec_attns) > 0 else {}
    dec_deform = dec_attns[1] if len(dec_attns) > 1 else {}

    pc_range = tuple(head.get("point_cloud_range",
                              cfg.get("point_cloud_range",
                                      VERConfig.pc_range)))
    kwargs: Dict[str, Any] = dict(
        pc_range=pc_range,
        bev_z=head.get("bev_z", VERConfig.bev_z),
        bev_h=head.get("bev_h", VERConfig.bev_h),
        bev_w=head.get("bev_w", VERConfig.bev_w),
        occupancy_size=tuple(head.get("occupancy_size",
                                      VERConfig.occupancy_size)),
        embed_dims=tr.get("embed_dims", VERConfig.embed_dims),
        encoder_layers=enc.get("num_layers", VERConfig.encoder_layers),
        sca_num_points=deform.get("num_points", VERConfig.sca_num_points),
        num_levels=deform.get("num_levels", VERConfig.num_levels),
        decoder_layers=dec.get("num_layers", VERConfig.decoder_layers),
        decoder_num_points=dec_deform.get("num_points",
                                          VERConfig.decoder_num_points),
        num_heads=dec_mha.get("num_heads",
                              deform.get("num_heads",
                                         VERConfig.num_heads)),
        ffn_dim=enc_layer.get("feedforward_channels", VERConfig.ffn_dim),
        num_query=head.get("num_query", VERConfig.num_query),
        num_classes=head.get("num_classes", VERConfig.num_classes),
        occupancy_classes=head.get("occupancy_classes",
                                   VERConfig.occupancy_classes),
        occ_dims=head.get("occ_dims", VERConfig.occ_dims),
        only_occ=head.get("only_occ", False),
        only_det=head.get("only_det", False),
        add_layout=head.get("add_layout", False),
        refine_occ=head.get("refine_occ", VERConfig.refine_occ),
        with_box_refine=head.get("with_box_refine", True),
        occ_loss_type=head.get("occ_loss_type", VERConfig.occ_loss_type),
        # reference-style file configs follow the ce convention by
        # contract, except occupancy_classes=16 (the focal-mode MP3D
        # real-class count), where VERConfig's guard must still fire
        occ_ce_includes_empty=head.get(
            "occ_ce_includes_empty",
            head.get("occ_loss_type") == "ce_loss"
            and head.get("occupancy_classes",
                         VERConfig.occupancy_classes)
            != MP3D_FOCAL_REAL_CLASSES),
        occ_layout=head.get("occ_layout", VERConfig.occ_layout),
        num_layout_query=head.get("num_layout_query",
                                  VERConfig.num_layout_query),
        code_size=head.get("code_size", VERConfig.code_size),
        layout_range=tuple(head.get("layout_range",
                                    VERConfig.layout_range)),
        num_reg_fcs=head.get("num_reg_fcs", VERConfig.num_reg_fcs),
        num_occ_fcs=head.get("num_occ_fcs", VERConfig.num_occ_fcs),
        bbox_max_num=_get(head, "bbox_coder", "max_num",
                          default=VERConfig.bbox_max_num),
        post_center_range=tuple(_get(
            head, "bbox_coder", "post_center_range",
            default=VERConfig.post_center_range)),
        decoder_on_bev=tr.get("decoder_on_bev", VERConfig.decoder_on_bev),
        voxel_2_bev_type=tr.get("voxel_2_bev_type",
                                VERConfig.voxel_2_bev_type),
        dropout_rate=enc_layer.get("ffn_dropout", VERConfig.dropout_rate),
        loss_cls_weight=_get(head, "loss_cls", "loss_weight",
                             default=VERConfig.loss_cls_weight),
        loss_bbox_weight=_get(head, "loss_bbox", "loss_weight",
                              default=VERConfig.loss_bbox_weight),
        loss_occ_weight=_get(head, "loss_occupancy", "loss_weight",
                             default=VERConfig.loss_occ_weight),
        loss_layout_weight=_get(head, "loss_layout", "loss_weight",
                                default=VERConfig.loss_layout_weight),
        # input-shape keys: reference configs hard-code 6x14x14x768, ours
        # may set them top-level
        num_cams=tr.get("num_cams", cfg.get("num_cams",
                                            VERConfig.num_cams)),
        feat_h=cfg.get("feat_h", VERConfig.feat_h),
        feat_w=cfg.get("feat_w", VERConfig.feat_w),
        in_channels=cfg.get("in_channels",
                            head.get("in_channels", VERConfig.in_channels)),
    )
    # top-level compute_dtype: 'bfloat16' | 'float32'
    dt = cfg.get("compute_dtype")
    if dt:
        kwargs["dtype"] = torch.bfloat16 if "bf" in str(dt) else torch.float32
    if cfg.get("remat_encoder") is not None:
        kwargs["remat_encoder"] = bool(cfg.get("remat_encoder"))
    if cfg.get("sca_query_capacity") is not None:
        kwargs["sca_query_capacity"] = int(cfg.get("sca_query_capacity"))
    kwargs.update(overrides)
    return VERConfig(**kwargs)


def build_train_config(cfg: Config, steps_per_epoch: int,
                       **overrides) -> TrainConfig:
    """Map the optimizer, lr_config and runner dicts onto TrainConfig
    (vocc.py:261-293: epoch-based warmup and cosine annealing), as the
    JAX package does (vln_ver_tpu/config/api.py:238-266)."""
    opt = cfg.get("optimizer", {})
    lr_cfg = cfg.get("lr_config", {})
    runner = cfg.get("runner", {})
    grad = _get(cfg, "optimizer_config", "grad_clip", "max_norm",
                default=300.0)
    total_epochs = runner.get("max_epochs", cfg.get("total_epochs", 500))
    warmup_iters = lr_cfg.get("warmup_iters", 30)
    if lr_cfg.get("warmup_by_epoch", False):
        warmup_steps = warmup_iters * steps_per_epoch
    else:
        warmup_steps = warmup_iters
    kwargs: Dict[str, Any] = dict(
        learning_rate=opt.get("lr", 1e-4),
        weight_decay=opt.get("weight_decay", 0.01),
        warmup_steps=max(int(warmup_steps), 1),
        total_steps=max(int(total_epochs * steps_per_epoch), 2),
        warmup_ratio=lr_cfg.get("warmup_ratio", 1.0 / 3.0),
        min_lr_ratio=lr_cfg.get("min_lr_ratio", 1e-3),
        grad_clip_norm=float(grad),
        # mmcv lr hooks default to by_epoch=True: epoch-granular anneal
        steps_per_epoch=(int(steps_per_epoch)
                         if lr_cfg.get("by_epoch", True) else 0),
    )
    kwargs.update(overrides)
    return TrainConfig(**kwargs)


def dataset_kwargs(cfg: Config, split: str = "train") -> Optional[Dict]:
    """Extract MP3DDataset kwargs from the data dict."""
    data = cfg.get("data", {})
    d = data.get(split)
    if d is None:
        return None
    return dict(
        ann_file=d.get("ann_file"),
        data_root=d.get("data_root", ""),
        classes=d.get("classes", ()),
        test_mode=d.get("test_mode", split != "train"),
    )
