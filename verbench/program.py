"""The system under test, as the benchmark builds it: the port's
``VoxelFormer`` with the benchmark's weights loaded by the published names.
Imported only by the drivers, inside a run."""

from __future__ import annotations

import dataclasses

import torch

from .reference.arch import Arch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def ver_config(a: Arch):
    """The port's ``VERConfig`` of a configuration file's ``model`` group."""
    from vln_ver_tpu_torch.models.config import VERConfig
    fields = {f.name for f in dataclasses.fields(VERConfig)}
    kw = {}
    for key, value in a.m.items():
        if key not in fields:
            raise ValueError(f"{key!r} is not a field of the program's "
                             "VERConfig")
        kw[key] = tuple(value) if isinstance(value, list) else value
    kw["dtype"] = DTYPES[a.m["dtype"]]
    return VERConfig(**kw)


def build_model(a: Arch, weights, device):
    """The port's model on ``device`` with ``weights`` loaded strictly:
    a name or shape the program does not have fails the run."""
    from vln_ver_tpu_torch.models.detector import VoxelFormer
    cfg = ver_config(a)
    with torch.device(device):
        model = VoxelFormer(cfg)
    model.load_state_dict(weights, strict=True)
    return model.eval(), cfg
