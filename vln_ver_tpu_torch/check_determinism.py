"""Bitwise determinism of the VER forward on the card (PyTorch port of
``tools/check_determinism.py``).

    python -m vln_ver_tpu_torch.check_determinism [--cams 36] [--batch 2]
        [--runs 3] [--device cuda|cpu]

Runs the full forward of ``VERConfig(num_cams=--cams, dtype=bfloat16)``
(random weights from seed 0) ``--runs`` times on the same example inputs
and compares a fingerprint of each output: the XOR of every fp32 bit
pattern of ``bev_embed``, ``occupancy_preds`` and ``all_bbox_preds``, as
one int32, folded on the device (:func:`fingerprint`), so a single
flipped bit anywhere shows and only three scalars cross to the host.
Prints each run's fingerprints and a summary naming the outputs that
differ; exits 1 when any does.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

OUTPUTS = ("bev_embed", "occupancy_preds", "all_bbox_preds")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.check_determinism")
    p.add_argument("--cams", type=int, default=36)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """The XOR of the int32 bit patterns of ``x`` in fp32: an int32
    scalar on ``x``'s device, folded in halves (XOR is associative and
    commutative, so this is ``lax.reduce(bits, 0, bitwise_xor)``)."""
    bits = x.detach().float().contiguous().view(torch.int32).reshape(-1)
    while bits.numel() > 1:
        half = bits.numel() // 2
        folded = bits[:half] ^ bits[half:2 * half]
        if bits.numel() % 2:
            folded[0] ^= bits[-1]
        bits = folded
    return bits.reshape(()) if bits.numel() else torch.zeros(
        (), dtype=torch.int32, device=x.device)


def run(args, cfg=None) -> dict:
    """Fingerprints of ``args.runs`` forwards of ``cfg`` (default:
    ``VERConfig(num_cams=args.cams, dtype=bfloat16)``); returns
    ``{"prints": [...], "bitwise_deterministic": bool, "differs": [output
    names]}``."""
    from .bench import example_inputs
    from .models import VERConfig, build_model
    from .runtime import resolve_device

    device = resolve_device(args.device)
    cfg = cfg or VERConfig(num_cams=args.cams, dtype=torch.bfloat16)
    model = build_model(cfg, device, seed=0)
    ins = [torch.from_numpy(a).to(device)
           for a in example_inputs(cfg, batch=args.batch)]

    @torch.inference_mode()
    def forward():
        outs = model(*ins)
        return torch.stack([fingerprint(outs[k]) for k in OUTPUTS]).tolist()

    prints = []
    for r in range(args.runs):
        prints.append(forward())
        print(json.dumps({"run": r, "fingerprint": dict(zip(
            OUTPUTS, prints[-1]))}), flush=True)
    differs = [k for i, k in enumerate(OUTPUTS)
               if any(p[i] != prints[0][i] for p in prints)]
    return {"prints": prints, "bitwise_deterministic": not differs,
            "differs": differs}


def main(argv=None) -> dict:
    args = parse_args(argv)
    res = run(args)
    print(json.dumps({"bitwise_deterministic": res["bitwise_deterministic"],
                      "runs": args.runs, "differs": res["differs"]}))
    if res["differs"]:
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
