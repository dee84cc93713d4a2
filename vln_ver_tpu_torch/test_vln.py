"""VLN agent evaluation CLI: greedy rollouts, SR / SPL / NE / oracle SR
(PyTorch port of ``tools/test_vln.py``).

Usage:
  python -m vln_ver_tpu_torch.test_vln --checkpoint work_dirs/vln/ckpt \
      --synthetic [--device cpu]
  python -m vln_ver_tpu_torch.test_vln --checkpoint ... --data-dir data/r2r \
      --connectivity data/connectivity --ver work_dirs/ver.hdf5 \
      [--split val_unseen] [--benchmark R2R|R4R|REVERIE] [--batch B]

``--checkpoint`` is a checkpoint directory of ``step_NNNNNNNN/model.pth``
policy state dicts (``utils.checkpoint.save_model``; the latest completed
step is read), a step directory, or a ``.pth`` file.  ``--synthetic``
builds the synthetic environment and the small policy of
``tools/test_vln.py --synthetic`` in memory.  Prints one JSON line of mean
metrics, rounded to 4 places.

Over several cards, one process each (torchrun's environment):
  torchrun --nproc-per-node N -m vln_ver_tpu_torch.test_vln ... --mesh N \
      [--batch B]
splits the episodes over the N ranks (lockstep batches of B / N each) and
gathers every episode's metrics (``rollout.episode_metrics``).
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.test_vln")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--connectivity", default=None)
    p.add_argument("--ver", default=None)
    p.add_argument("--split", default="val_unseen")
    p.add_argument("--benchmark", default="R2R",
                   choices=["R2R", "R4R", "REVERIE"])
    p.add_argument("--objects", default=None,
                   help="REVERIE candidate-objects pkl, or 'synthetic'")
    p.add_argument("--bert-vocab", default=None,
                   help="BERT vocab.txt for checkpoints trained with "
                        "--bert-vocab (else the train split's vocab is "
                        "rebuilt for tokenization)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--embed-dims", type=int, default=None)
    p.add_argument("--work-dir", default="work_dirs/vln")
    p.add_argument("--batch", type=int, default=None,
                   help="lockstep-batched eval: episodes per policy call "
                        "(rollout.evaluate_batched; default: per-episode)")
    p.add_argument("--mesh", type=int, default=None,
                   help="split the episodes over N processes (torchrun); "
                        "lockstep batches of --batch (default N) split "
                        "over them")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .agent.env import R2REnv, make_synthetic_vln
    from .agent.policy import PolicyConfig, VLNPolicy
    from .agent.rollout import evaluate, evaluate_batched
    from .parallel import multihost
    from .parallel.mesh import make_mesh
    from .runtime import resolve_device, set_fp32_precision
    from .utils.checkpoint import latest_step, load_model

    device = multihost.initialize_if_needed(resolve_device(args.device))
    mesh = make_mesh((args.mesh, 1)) if args.mesh else None
    if args.synthetic:
        dims = args.embed_dims or 64
        cfg = PolicyConfig(embed_dims=dims, num_heads=4, fusion_layers=2,
                           text_layers=2, ffn_dim=2 * dims, vocab_size=128,
                           max_text_len=16, max_nodes=16, bev_z=2,
                           bev_h=4, bev_w=4, num_query_tokens=4)
        objects = None
        made = make_synthetic_vln(
            os.path.join(args.work_dir, "synvln"), num_scans=2,
            nodes_per_scan=9, num_episodes=16,
            bev_num=cfg.bev_z * cfg.bev_h * cfg.bev_w,
            embed_dims=dims, max_text_len=cfg.max_text_len,
            with_objects=args.objects == "synthetic")
        if args.objects == "synthetic":
            episodes, graphs, ver, objects = made
        else:
            episodes, graphs, ver = made
    else:
        from .agent.data import (WordPieceVocab, load_graphs,
                                 load_r2r_split, load_ver_features)
        dims = args.embed_dims or 768
        # tokenize with the TRAINING vocab (ids are corpus-frequency
        # dependent): a vocab rebuilt from the eval split would index the
        # embedding rows with wrong token ids
        vocab0 = (WordPieceVocab(args.bert_vocab) if args.bert_vocab
                  else load_r2r_split(args.data_dir, "train", None, 80,
                                      prefix=args.benchmark)[1])
        episodes, vocab = load_r2r_split(args.data_dir, args.split,
                                         vocab0, 80,
                                         prefix=args.benchmark)
        cfg = PolicyConfig(embed_dims=dims, vocab_size=len(vocab))
        graphs = load_graphs(args.connectivity,
                             [e["scan"] for e in episodes])
        ver = load_ver_features(args.ver)
        objects = None
        if args.objects and args.objects != "synthetic":
            import pickle
            with open(args.objects, "rb") as f:
                objects = pickle.load(f)

    set_fp32_precision(cfg.dtype)
    env = R2REnv(episodes, graphs, ver, max_nodes=cfg.max_nodes,
                 objects=objects)
    policy = VLNPolicy(cfg, grounding=objects is not None).to(device).eval()
    step = latest_step(args.checkpoint)
    load_model(args.checkpoint, policy)   # strict: every weight is read
    print(f"restored policy step {step}")

    if args.batch or mesh is not None:
        metrics = evaluate_batched(policy, env, cfg, limit=args.limit,
                                   batch_size=args.batch or args.mesh,
                                   mesh=mesh)
    else:
        metrics = evaluate(policy, env, cfg, limit=args.limit)
    out = {k: round(float(v), 4) for k, v in metrics.items()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
