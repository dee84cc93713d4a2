"""Print the merged config and the dataclass configs it resolves to
(PyTorch port of ``tools/print_config.py``, the reference's
tools/misc/print_config.py).

    python -m vln_ver_tpu_torch.print_config configs/verformer/vocc.py
        [--cfg-options key=value ...] [--steps-per-epoch 100]
        [--device cuda|cpu]

Shows the config dict after ``_base_`` merging and ``--cfg-options``, then
the ``VERConfig`` and ``TrainConfig`` it maps to, dtypes by name
(``float32``).  Nothing here runs on a device: ``--device`` is taken as
every CLI of the port takes it, and only checked.
"""

from __future__ import annotations

import argparse
import pprint

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.print_config")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--steps-per-epoch", type=int, default=100,
                   help="used to resolve epoch-based schedule fields")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _show(value):
    return str(value).split(".")[-1] if isinstance(value, torch.dtype) \
        else value


def main(argv=None) -> None:
    args = parse_args(argv)
    from .config.api import (apply_cfg_options, build_train_config,
                             build_ver_config, load_config)
    from .runtime import resolve_device

    resolve_device(args.device)
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    print(f"# merged config: {args.config}")
    pprint.pprint(dict(cfg), width=100, sort_dicts=False)

    ver = build_ver_config(cfg)
    tc = build_train_config(cfg, args.steps_per_epoch)
    print("\n# resolved VERConfig")
    for k, v in sorted(vars(ver).items()):
        print(f"  {k} = {_show(v)}")
    print(f"\n# resolved TrainConfig (steps/epoch={args.steps_per_epoch})")
    for k, v in sorted(vars(tc).items()):
        print(f"  {k} = {_show(v)}")


if __name__ == "__main__":
    main()
