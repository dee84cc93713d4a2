"""Parameter-count report (PyTorch port of ``tools/get_params.py``, the
reference's tools/analysis_tools/get_params.py).

    python -m vln_ver_tpu_torch.get_params [configs/verformer/vocc.py]
        [--device cuda|cpu]

Builds the model (``VERConfig()`` without a config) on ``--device`` and
prints its 20 largest groups of parameters, by the first three parts of
their names, then the total, in millions.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.get_params")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Prints the report; returns ``{"groups": {name: count}, "total":
    count}``."""
    args = parse_args(argv)
    from .config.api import build_ver_config, load_config
    from .models import VERConfig, VoxelFormer
    from .runtime import resolve_device

    device = resolve_device(args.device)
    cfg = (build_ver_config(load_config(args.config)) if args.config
           else VERConfig())
    with device:
        model = VoxelFormer(cfg)
    groups: dict = {}
    total = 0
    for name, p in model.named_parameters():
        top = "/".join(name.split(".")[:3])
        groups[top] = groups.get(top, 0) + p.numel()
        total += p.numel()
    for name in sorted(groups, key=groups.get, reverse=True)[:20]:
        print(f"{groups[name]/1e6:8.2f}M  {name}")
    print(f"{total/1e6:8.2f}M  TOTAL")
    return {"groups": groups, "total": total}


if __name__ == "__main__":
    main()
