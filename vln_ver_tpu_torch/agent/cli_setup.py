"""Shared setup of the agent's trainer CLIs, ``train_vln`` and
``pretrain_vln`` (PyTorch port of ``vln_ver_tpu/agent/cli_setup.py``).

``train_vln --init-from-pretrain`` loads a checkpoint into a policy built
from the same config and environment plumbing that made it, so that
plumbing exists once, here: synthetic or real data, the
``PolicyConfig``, the converted pretrained text and cross-modal files with
their architecture overrides, and the grafts.

The converted files are the port's own (``python -m
vln_ver_tpu_torch.convert_text_encoder`` / ``convert_crossmodal``), written
with ``torch.save`` as ``{"meta": {...}, "state_dict": {...}}``: the text
encoder's state dict, and the fusion blocks' under ``local_block_i.`` /
``global_block_i.``.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace
from typing import Dict

import torch

from .policy import PolicyConfig, VLNPolicy

MAX_TEXT_LEN = 80


def load_converted(path: str) -> Dict:
    """A converted file: ``{"meta": {name: int}, "state_dict": {...}}``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return {"meta": {k: int(v) for k, v in blob["meta"].items()},
            "state_dict": dict(blob["state_dict"])}


def load_text_init(path: str):
    """The converted BERT file -> (``PolicyConfig`` overrides, the text
    encoder's state dict), the position table truncated to the chosen
    ``max_text_len`` (at most 80) so that it loads into the encoder."""
    blob = load_converted(path)
    meta, sd = blob["meta"], blob["state_dict"]
    max_text_len = min(meta["max_len"], MAX_TEXT_LEN)
    overrides = dict(
        text_arch="bert", vocab_size=meta["vocab_size"],
        text_layers=meta["num_layers"], text_ffn_dim=meta["ffn_dim"],
        embed_dims=meta["hidden"], max_text_len=max_text_len)
    sd["pos_embed"] = sd["pos_embed"][:max_text_len].clone()
    return overrides, sd


def build_vln_setup(args) -> SimpleNamespace:
    """One setup for pretraining and finetuning.

    Reads from ``args``: synthetic, work_dir, embed_dims, objects,
    data_dir, connectivity, ver, benchmark, bert_vocab, and (optional,
    default None / 1) text_init, crossmodal_init, mask_id.

    Returns a namespace with cfg (``PolicyConfig`` with the pretrained
    architecture's overrides), episodes, graphs, ver, objects, mask_id,
    special_ids, text_params and xmodal; the grafts are applied by
    :func:`graft_pretrained`."""
    from .env import make_synthetic_vln

    # text overrides first: the tokenized instruction length must match
    # the (possibly truncated) position table
    text_overrides, text_params = (None, None)
    if getattr(args, "text_init", None):
        text_overrides, text_params = load_text_init(args.text_init)
    text_len = (text_overrides["max_text_len"] if text_overrides
                else MAX_TEXT_LEN)

    xmodal = None
    if getattr(args, "crossmodal_init", None):
        xmodal = load_converted(args.crossmodal_init)

    default_mask_id = getattr(args, "mask_id", 1)
    special_ids: tuple = ()
    if (args.synthetic and args.objects
            and args.objects != "synthetic"):
        raise SystemExit(
            f"--synthetic with --objects {args.objects!r}: a real object "
            "pickle cannot pair with synthetic scans (their viewpoint "
            "tokens won't match) — pass --objects synthetic to rehearse "
            "grounding, or drop --synthetic")
    if args.synthetic:
        # the pretrained architecture's overrides shape the synthetic data
        # too (its volumes have the policy's width)
        dims = (text_overrides["embed_dims"] if text_overrides
                else args.embed_dims or 64)
        tlen = (text_overrides["max_text_len"] if text_overrides else 16)
        vocab = (text_overrides["vocab_size"] if text_overrides else 128)
        cfg = PolicyConfig(embed_dims=dims, num_heads=4, fusion_layers=2,
                           text_layers=2, ffn_dim=2 * dims,
                           vocab_size=vocab,
                           max_text_len=tlen, max_nodes=16, bev_z=2,
                           bev_h=4, bev_w=4, num_query_tokens=4)
        bev_num = cfg.bev_z * cfg.bev_h * cfg.bev_w
        objects = None
        made = make_synthetic_vln(
            os.path.join(args.work_dir, "synvln"), num_scans=2,
            nodes_per_scan=9, num_episodes=16, bev_num=bev_num,
            embed_dims=dims, max_text_len=cfg.max_text_len,
            with_objects=args.objects == "synthetic")
        if args.objects == "synthetic":
            episodes, graphs, ver, objects = made
        else:
            episodes, graphs, ver = made
        mask_id = default_mask_id
    else:
        from .data import (WordPieceVocab, load_graphs, load_r2r_split,
                           load_ver_features)
        dims = args.embed_dims or 768
        vocab0 = (WordPieceVocab(args.bert_vocab)
                  if args.bert_vocab else None)
        episodes, vocab = load_r2r_split(args.data_dir, "train", vocab0,
                                         text_len, prefix=args.benchmark)
        cfg = PolicyConfig(embed_dims=dims, vocab_size=len(vocab))
        graphs = load_graphs(args.connectivity,
                             [e["scan"] for e in episodes])
        ver = load_ver_features(args.ver)
        mask_id = (vocab.stoi.get("[MASK]", default_mask_id)
                   if args.bert_vocab else default_mask_id)
        if args.bert_vocab:
            # BERT's create_masked_lm_predictions never masks the
            # sentence delimiters
            special_ids = tuple(
                vocab.stoi[t] for t in ("[CLS]", "[SEP]")
                if t in vocab.stoi)
        objects = None
        if args.objects and args.objects != "synthetic":
            import pickle
            with open(args.objects, "rb") as f:
                objects = pickle.load(f)

    if text_overrides:
        cfg = dataclasses.replace(cfg, **text_overrides)
        print(f"text-init: BERT arch, "
              f"{text_overrides['text_layers']} layers, "
              f"hidden {text_overrides['embed_dims']}, "
              f"vocab {text_overrides['vocab_size']}, "
              f"max_text_len {text_overrides['max_text_len']}")
    if xmodal is not None:
        meta = xmodal["meta"]
        if meta["hidden"] != cfg.embed_dims:
            raise SystemExit(
                f"--crossmodal-init hidden {meta['hidden']} != policy "
                f"embed_dims {cfg.embed_dims} (pair it with a matching "
                "--text-init)")
        cfg = dataclasses.replace(cfg, fusion_arch="bert",
                                  fusion_layers=meta["num_layers"],
                                  num_heads=meta["num_heads"],
                                  ffn_dim=meta["ffn_dim"])
        print(f"crossmodal-init: LXMERT/DUET x-layers, "
              f"{meta['num_layers']} layers, ffn {meta['ffn_dim']}, "
              f"{meta['num_heads']} heads")

    return SimpleNamespace(cfg=cfg, episodes=episodes, graphs=graphs,
                           ver=ver, objects=objects, mask_id=mask_id,
                           special_ids=special_ids,
                           text_params=text_params, xmodal=xmodal)


def graft_pretrained(policy: VLNPolicy, cfg: PolicyConfig, text_params,
                     xmodal) -> VLNPolicy:
    """Load converted pretrained weights into ``policy`` in place, each
    module strictly: the text encoder's from ``text_params``, every
    ``local_block_i`` / ``global_block_i`` from ``xmodal``.  Returns
    ``policy``."""
    if text_params is not None:
        policy.text_encoder.load_state_dict(text_params, strict=True)
    if xmodal is not None:
        sd = xmodal["state_dict"]
        for kind in ("local", "global"):
            for i in range(cfg.fusion_layers):
                name = f"{kind}_block_{i}."
                getattr(policy, name[:-1]).load_state_dict(
                    {k[len(name):]: v for k, v in sd.items()
                     if k.startswith(name)}, strict=True)
    return policy
