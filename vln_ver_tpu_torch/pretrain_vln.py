"""VLN pretraining CLI: DUET-lineage proxy tasks (MLM + SAP, + OG with
REVERIE objects) over offline teacher trajectories (PyTorch port of
``tools/pretrain_vln.py``).

Usage:
  python -m vln_ver_tpu_torch.pretrain_vln --synthetic --steps 300 \\
      [--device cpu]                                          # rehearsal
  python -m vln_ver_tpu_torch.pretrain_vln --data-dir data/r2r \\
      --ver data/ver.hdf5 --connectivity data/connectivity --steps 20000

Then finetune from it:
  python -m vln_ver_tpu_torch.train_vln ... \\
      --init-from-pretrain work_dirs/vln_pre/ckpt

The offline records are collected once; each update draws ``--batch`` of
them with one ``np.random.default_rng(seed)``, masks the instructions
with a ``torch.Generator`` of ``seed + 11`` and runs the model in
``train()``, with dropout.  The update is clip 40 plus AdamW with optax's
defaults (``agent/update.py``).  The ``VLNPretrainModel`` state dict is
saved at the end as ``<work-dir>/ckpt/step_NNNNNNNN/model.pth``.

``--mesh N`` (torchrun, one process a card, N the world size) splits each
update's batch over the ranks: every rank draws the same records and
masks, takes its rows, and the update equals the one-process update
(``agent.parallel``); rank 0 writes the log and the checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.pretrain_vln")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--connectivity", default=None)
    p.add_argument("--ver", default=None, help="VER hdf5 from get_occ")
    p.add_argument("--benchmark", default="R2R",
                   choices=["R2R", "R4R", "REVERIE"])
    p.add_argument("--objects", default=None,
                   help="REVERIE candidate objects pkl (or 'synthetic')")
    p.add_argument("--steps", type=int, default=300,
                   help="optimizer updates")
    p.add_argument("--batch", type=int, default=16,
                   help="decision steps per update")
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--mask-id", type=int, default=1,
                   help="[MASK] token id (1 = <unk> for the plain vocab; "
                        "the vocab's [MASK] with --bert-vocab)")
    p.add_argument("--bert-vocab", default=None)
    p.add_argument("--text-init", default=None,
                   help="file from python -m "
                        "vln_ver_tpu_torch.convert_text_encoder; "
                        "pretraining starts from BERT text weights; pass "
                        "the same flag to train_vln --init-from-pretrain")
    p.add_argument("--crossmodal-init", default=None,
                   help="file from python -m "
                        "vln_ver_tpu_torch.convert_crossmodal; "
                        "pretraining starts from LXMERT/DUET x-layers")
    p.add_argument("--embed-dims", type=int, default=None)
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel updates over N processes (torchrun; "
                        "--batch must divide by N)")
    p.add_argument("--work-dir", default="work_dirs/vln_pre")
    p.add_argument("--log-interval", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def pretrain_updates(model, state, records, batch_size: int,
                     rng: np.random.Generator, generator, device,
                     mask_id: int = 1, special_ids: tuple = (),
                     stages=None, mesh=None):
    """The pretrainer's loop, as a generator: draw ``batch_size`` records,
    stack and upload them, take one update of ``pretrain_loss``; yields
    (update, loss, parts) after each.  ``stages`` gathers the CUDA events
    of ``agent.update.mark``: ``"start"``, ``"upload"``, then the
    update's.  With ``mesh`` this rank stacks its rows of the drawn
    records (``agent.update.update``'s ``mesh``)."""
    from .agent.parallel import shard_agent_batch
    from .agent.pretrain import pretrain_loss, stack_records
    from .agent.update import mark, update

    step = 0
    while True:
        idx = rng.integers(0, len(records), batch_size)
        if mesh is not None:
            idx = shard_agent_batch(mesh, idx)
        mark(stages, "start")
        batch = stack_records([records[i] for i in idx], device)
        mark(stages, "upload")
        loss, parts, _ = update(state, lambda: pretrain_loss(
            model, batch, generator, mask_id=mask_id,
            special_ids=special_ids), stages, mesh=mesh)
        step += 1
        yield step, loss, parts


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    import torch

    from .agent.cli_setup import build_vln_setup, graft_pretrained
    from .agent.env import R2REnv
    from .agent.pretrain import (VLNPretrainModel, collect_teacher_trace,
                                 init_pretrain_params)
    from .agent.update import make_train_state
    from .parallel import multihost
    from .parallel.mesh import make_mesh, replicate
    from .runtime import resolve_device, set_fp32_precision
    from .utils.checkpoint import save_model

    device = multihost.initialize_if_needed(resolve_device(args.device))
    mesh = make_mesh((args.mesh, 1)) if args.mesh else None
    if mesh is not None and args.batch % args.mesh:
        raise SystemExit(f"--batch {args.batch} must divide by --mesh "
                         f"{args.mesh}")
    writer = multihost.process_index() == 0
    os.makedirs(args.work_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)        # the dropout masks

    setup = build_vln_setup(args)
    cfg, episodes, objects = setup.cfg, setup.episodes, setup.objects
    set_fp32_precision(cfg.dtype)
    env = R2REnv(episodes, setup.graphs, setup.ver,
                 max_nodes=cfg.max_nodes, objects=objects)
    model = init_pretrain_params(
        VLNPretrainModel(cfg, grounding=objects is not None), args.seed)
    graft_pretrained(model.policy, cfg, setup.text_params, setup.xmodal)
    model = model.to(device).train()     # dropout on, as in JAX
    if mesh is not None:
        replicate(mesh, model)
    n = sum(p.numel() for p in model.parameters())
    print(f"pretrain params: {n / 1e6:.2f}M, episodes: {len(episodes)}, "
          f"mask_id: {setup.mask_id}")

    # offline teacher trajectories, collected once (DUET pretrains on a
    # fixed offline dataset)
    records = []
    for i in range(len(episodes)):
        records.extend(collect_teacher_trace(env, i, cfg))
    print(f"offline dataset: {len(records)} decision steps from "
          f"{len(episodes)} episodes")

    state = make_train_state(model, args.lr)
    generator = torch.Generator(device=device).manual_seed(args.seed + 11)
    updates = pretrain_updates(model, state, records, args.batch, rng,
                               generator, device, mask_id=setup.mask_id,
                               special_ids=setup.special_ids, mesh=mesh)
    m: Dict[str, float] = {}
    t0 = time.perf_counter()
    with open(os.path.join(args.work_dir, "pretrain_log.jsonl")
              if writer else os.devnull, "a") as logf:
        for _ in range(args.steps):
            step, loss, parts = next(updates)
            if step % args.log_interval == 0 or step == args.steps:
                m = {k: round(float(v), 4) for k, v in parts.items()}
                m.update(step=step, loss=round(float(loss), 4),
                         sec_per_step=round(
                             (time.perf_counter() - t0) / step, 3))
                print(f"step {step}: {m}")
                logf.write(json.dumps(m) + "\n")
                logf.flush()

    if writer:
        save_model(os.path.join(args.work_dir, "ckpt"), args.steps, model)
        print(f"saved pretrain params at step {args.steps}")
    print("done")
    return m


if __name__ == "__main__":
    main()
