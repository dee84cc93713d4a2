"""Forward throughput CLI (PyTorch port of ``tools/benchmark.py``, the
reference's ``tools/analysis_tools/benchmark.py`` surface).

    python -m vln_ver_tpu_torch.benchmark [configs/verformer/vocc.py]
        [--num-cams N] [--batch-size B] [--iters N] [--warmup N] [--bf16]
        [--mode full|bev] [--device cuda|cpu]

Times the forward of a model with random weights from seed 0 on the
example inputs of ``vln_ver_tpu_torch.bench`` (``--mode full``: every head
output; ``bev``: the lift alone), ``--iters`` back-to-back warm calls
between CUDA events, the least of three samples
(``utils.bench.event_time``).  Without a config the model is
``VERConfig(num_cams=--num-cams or 6)``.  Prints the JAX tool's two lines
and the card.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.benchmark")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--num-cams", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--mode", choices=["full", "bev"], default="full")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .bench import example_inputs
    from .config.api import build_ver_config, load_config
    from .models import VERConfig, build_model
    from .runtime import resolve_device, set_fp32_precision
    from .utils.bench import card_name, event_time, full_forward_step

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.config:
        overrides = {"dtype": dtype} if args.bf16 else {}
        if args.num_cams:
            overrides["num_cams"] = args.num_cams
        cfg = build_ver_config(load_config(args.config), **overrides)
    else:
        cfg = VERConfig(num_cams=args.num_cams or 6, dtype=dtype)
    set_fp32_precision(cfg.dtype)
    model = build_model(cfg, device, seed=0)
    ins = [torch.from_numpy(a).to(device)
           for a in example_inputs(cfg, batch=args.batch_size)]
    step = full_forward_step(model, only_bev=args.mode == "bev")
    sec = event_time(lambda: step(*ins), device, args.iters,
                     warmup=args.warmup)
    fps = args.batch_size / sec
    card = card_name(device)
    dtype_name = str(cfg.dtype).split(".")[-1]
    print(f"device={device.type} cams={cfg.num_cams} "
          f"batch={args.batch_size} mode={args.mode} dtype={dtype_name}")
    print(f"throughput: {fps:.3f} samples/s ({sec * 1000:.1f} ms/iter)")
    print(f"card: {card}")
    return {"samples_per_sec": fps, "sec_per_iter": sec, "card": card}


if __name__ == "__main__":
    main()
