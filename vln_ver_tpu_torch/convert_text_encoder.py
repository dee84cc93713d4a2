"""Convert a pretrained HuggingFace BERT checkpoint into the VLN policy's
text encoder (PyTorch port of ``tools/convert_text_encoder.py``).

The policy's instruction branch (``agent/text.py``) has ``arch="bert"``,
HF ``BertModel``'s encoder layout, so pretrained weights carry over
function for function.  This tool maps a torch state dict onto
``TextEncoder(arch="bert")``'s names and writes a file for ``python -m
vln_ver_tpu_torch.train_vln --text-init`` / ``pretrain_vln --text-init``:
``torch.save({"meta": {...}, "state_dict": {...}})``.

Sources accepted by --src:
  * a torch checkpoint file (``pytorch_model.bin`` / ``*.pt``) holding a
    BertModel state dict, optionally nested under ``state_dict`` /
    ``model`` and/or prefixed ``bert.``;
  * a HF model directory containing ``pytorch_model.bin``.
It is read with ``torch.load(weights_only=True)``: tensors and plain
containers only.

Usage:
  python -m vln_ver_tpu_torch.convert_text_encoder --src /path/to/bert \\
      --out bert.pt [--heads 12] [--max-len 80]
"""

from __future__ import annotations

import argparse
import os
import re

import torch


def load_state_dict(src: str):
    """The tensors of a torch checkpoint file, or of the one in a model
    directory, unwrapped from a ``state_dict`` / ``model`` entry."""
    path = src
    if os.path.isdir(src):
        for name in ("pytorch_model.bin", "model.pt", "model.bin"):
            cand = os.path.join(src, name)
            if os.path.isfile(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no torch checkpoint in {src}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return {k: v for k, v in sd.items() if hasattr(v, "shape")}


def detect_layout(sd):
    """(key prefix, number of encoder layers) of a BERT state dict."""
    prefix = ""
    if not any(k.startswith("embeddings.") for k in sd):
        for cand in ("bert.", "encoder.", "lxrt_encoder.model.bert."):
            if any(k.startswith(cand + "embeddings.") for k in sd):
                prefix = cand
                break
    layers = set()
    pat = re.compile(re.escape(prefix) + r"encoder\.layer\.(\d+)\.")
    for k in sd:
        m = pat.match(k)
        if m:
            layers.add(int(m.group(1)))
    if not layers:
        raise ValueError("no encoder.layer.N keys found "
                         f"(prefix detected: {prefix!r})")
    return prefix, max(layers) + 1


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.convert_text_encoder")
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--max-len", type=int, default=None,
                   help="truncate the position table (default: keep all)")
    args = p.parse_args(argv)

    from .agent.text import convert_hf_bert_params

    sd = load_state_dict(args.src)
    prefix, num_layers = detect_layout(sd)
    out = convert_hf_bert_params(sd, num_layers=num_layers,
                                 num_heads=args.heads, prefix=prefix)
    if args.max_len is not None:
        out["pos_embed"] = out["pos_embed"][:args.max_len].clone()
    vocab_size, hidden = out["token_embed.weight"].shape
    meta = dict(num_layers=num_layers, num_heads=args.heads, hidden=hidden,
                vocab_size=vocab_size, max_len=out["pos_embed"].shape[0],
                ffn_dim=out["fc1_0.weight"].shape[0])
    torch.save({"meta": meta, "state_dict": out}, args.out)
    n = sum(v.numel() for v in out.values())
    print(f"converted {n / 1e6:.1f}M params "
          f"({num_layers} layers, hidden {hidden}) -> {args.out}")
    print("meta:", meta)
    return meta


if __name__ == "__main__":
    main()
