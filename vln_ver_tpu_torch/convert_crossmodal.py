"""Convert DUET / LXMERT cross-modal pretrained weights into the VLN
policy's fusion blocks (PyTorch port of ``tools/convert_crossmodal.py``).

The cross-modal x-layers of a DUET / HAMT (or HF LXMERT) torch checkpoint
map onto ``VLNPolicy(fusion_arch="bert")``'s local and global fusion
blocks (``agent/crossmodal.py``).  DUET checkpoints carry two stacks (the
coarse "global" map branch and the fine "local" one); LXMERT carries one,
which then goes into both branches.  The file written, for ``python -m
vln_ver_tpu_torch.train_vln --crossmodal-init``, is
``torch.save({"meta": {...}, "state_dict": {...}})`` with the blocks under
``local_block_i.`` / ``global_block_i.``.

Usage:
  python -m vln_ver_tpu_torch.convert_crossmodal --src duet.pt \\
      --out xmodal.pt [--heads 12] [--global-prefix global_encoder.] \\
      [--local-prefix ...]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.convert_crossmodal")
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--global-prefix", default=None,
                   help="state-dict prefix of the global-branch x_layers "
                        "(detected when omitted)")
    p.add_argument("--local-prefix", default=None)
    args = p.parse_args(argv)

    from .agent.crossmodal import convert_crossmodal_params, detect_x_layers
    from .convert_text_encoder import load_state_dict

    sd = load_state_dict(args.src)
    stacks = detect_x_layers(sd)
    if not stacks:
        raise SystemExit("no x_layers.N. keys found in the checkpoint")
    print("detected x-layer stacks:", stacks)

    def pick(want, flag):
        if flag is not None:
            return flag
        cands = [p for p in stacks if want in p]
        if len(cands) == 1:
            return cands[0]
        if len(stacks) == 1:
            return next(iter(stacks))
        raise SystemExit(
            f"ambiguous {want} stack among {list(stacks)}; pass "
            f"--{want}-prefix")

    gp = pick("global", args.global_prefix)
    lp = pick("local", args.local_prefix)
    out = {}
    for kind, prefix in (("global", gp), ("local", lp)):
        blocks = convert_crossmodal_params(sd, stacks[prefix], args.heads,
                                           prefix=prefix)
        for block, params in blocks.items():
            i = block.split("_")[1]
            out.update({f"{kind}_block_{i}.{k}": v
                        for k, v in params.items()})
    ffn, hidden = out["global_block_0.fc1.weight"].shape
    meta = dict(num_heads=args.heads, num_layers=stacks[gp], hidden=hidden,
                ffn_dim=ffn)
    torch.save({"meta": meta, "state_dict": out}, args.out)
    n = sum(v.numel() for v in out.values())
    print(f"converted {n / 1e6:.1f}M cross-modal params "
          f"({stacks[gp]} layers, hidden {hidden}, ffn {ffn}, "
          f"global={gp!r} local={lp!r}) -> {args.out}")
    return meta


if __name__ == "__main__":
    main()
