"""VLN agent imitation training with DAgger over VER volumes (PyTorch port of
``tools/train_vln.py``): cross-entropy to the shortest-path teacher's
action at every visited step, on rollouts that take the student's sampled
actions with probability ``--sample-prob`` (ramped in over
``--dagger-ramp`` updates), with periodic greedy evaluation (SR / SPL /
nav error / oracle SR).

Usage:
  python -m vln_ver_tpu_torch.train_vln --synthetic --steps 200 \\
      [--device cpu]                                          # rehearsal
  python -m vln_ver_tpu_torch.train_vln --data-dir data/r2r \\
      --ver data/ver.hdf5 --connectivity data/connectivity      # real R2R
  python -m vln_ver_tpu_torch.train_vln ... \\
      --init-from-pretrain work_dirs/vln_pre/ckpt              # finetune

The policy runs with dropout off throughout, as in the JAX trainer (its
update applies the policy with no ``deterministic=False``).  The update is
clip 40 plus AdamW with optax's defaults (``agent/update.py``).  One
``np.random.default_rng(seed)`` picks the episodes and the student /
teacher coin, as in JAX; a ``torch.Generator`` of ``seed + 7`` draws the
sampled actions.  The policy is saved at the end as
``<work-dir>/ckpt/step_NNNNNNNN/model.pth``, which ``python -m
vln_ver_tpu_torch.test_vln --checkpoint`` reads.

``--mesh N`` (torchrun, one process a card, N the world size): every rank
rolls the same episodes (the policy is the same everywhere) and each
update's decision steps are split over the ranks; the update equals the
one-process update (``agent.parallel``).  Rank 0 writes the log and the
checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.train_vln")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--connectivity", default=None)
    p.add_argument("--ver", default=None, help="VER hdf5 from get_occ")
    p.add_argument("--benchmark", default="R2R",
                   choices=["R2R", "R4R", "REVERIE"])
    p.add_argument("--objects", default=None,
                   help="REVERIE candidate objects pkl: "
                        "{token: {'ids': [...], 'feats': (N, C)}}; with "
                        "--synthetic, pass 'synthetic' to rehearse "
                        "grounding")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eval-interval", type=int, default=100)
    p.add_argument("--eval-limit", type=int, default=8)
    p.add_argument("--sample-prob", type=float, default=0.5,
                   help="fraction of rollouts with sampled (student) "
                        "actions, DAgger-style; teacher labels either way")
    p.add_argument("--dagger-ramp", type=int, default=0,
                   help="linearly ramp the student-action fraction from 0 "
                        "to --sample-prob over this many steps; 0 = "
                        "constant")
    p.add_argument("--episode-batch", type=int, default=1,
                   help="roll this many episodes in lockstep per outer "
                        "iteration (one policy call per step for the "
                        "whole batch)")
    p.add_argument("--update-batch", type=int, default=8,
                   help="decision steps per optimizer update (rollout "
                        "steps are buffered and stacked)")
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel updates over N processes (torchrun; "
                        "--update-batch must divide by N)")
    p.add_argument("--work-dir", default="work_dirs/vln")
    p.add_argument("--embed-dims", type=int, default=None)
    p.add_argument("--text-init", default=None,
                   help="file from python -m "
                        "vln_ver_tpu_torch.convert_text_encoder; grafts "
                        "pretrained BERT weights into the instruction "
                        "branch (sets text_arch='bert')")
    p.add_argument("--bert-vocab", default=None,
                   help="BERT vocab.txt; tokenize instructions with "
                        "WordPiece so ids match --text-init embeddings")
    p.add_argument("--init-from-pretrain", default=None,
                   help="checkpoint dir from python -m "
                        "vln_ver_tpu_torch.pretrain_vln; loads the "
                        "pretrained policy subtree (MLM head dropped)")
    p.add_argument("--crossmodal-init", default=None,
                   help="file from python -m "
                        "vln_ver_tpu_torch.convert_crossmodal; grafts "
                        "pretrained DUET/LXMERT x-layers into the local/"
                        "global fusion blocks (sets fusion_arch='bert')")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def dagger_updates(policy, state, env, cfg, rng: np.random.Generator,
                   generator, device, sample_prob: float = 0.5,
                   dagger_ramp: int = 0, episode_batch: int = 1,
                   update_batch: int = 8, mesh=None):
    """The trainer's loop, as a generator: roll episodes (greedy, or with
    sampled actions with probability ``sample_prob`` ramped over
    ``dagger_ramp`` steps), buffer their teacher-labelled steps, and take
    one update per ``update_batch`` of them; yields (steps trained, loss,
    parts) after every update.  With ``mesh`` each update stacks this
    rank's rows of the decision steps (``agent.update.update``'s
    ``mesh``)."""
    from .agent.parallel import shard_agent_batch
    from .agent.pretrain import stack_records
    from .agent.rollout import (imitation_step_loss, run_episode,
                                run_episodes_batched)
    from .agent.update import update

    step, buffer = 0, []
    while True:
        p_sample = sample_prob
        if dagger_ramp > 0:
            p_sample *= min(1.0, step / dagger_ramp)
        sample = bool(rng.uniform() < p_sample)
        if episode_batch > 1:
            idxs = [int(rng.integers(len(env.episodes)))
                    for _ in range(episode_batch)]
            _, traces = run_episodes_batched(
                policy, env, idxs, cfg, greedy=not sample,
                generator=generator, collect_teacher=True)
            for t in traces:
                buffer.extend(t)
        else:
            ep_idx = int(rng.integers(len(env.episodes)))
            _, trace = run_episode(policy, env, ep_idx, cfg,
                                   greedy=not sample, generator=generator,
                                   collect_teacher=True)
            buffer.extend(trace)
        while len(buffer) >= update_batch:
            chunk, buffer = buffer[:update_batch], buffer[update_batch:]
            rows = (chunk if mesh is None else
                    [chunk[i] for i in shard_agent_batch(
                        mesh, np.arange(len(chunk)))])
            batch = stack_records(rows, device)
            loss, parts, _ = update(
                state, lambda: imitation_step_loss(policy, batch),
                mesh=mesh)
            step += len(chunk)
            yield step, loss, parts


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    import torch

    from .agent.cli_setup import build_vln_setup, graft_pretrained
    from .agent.env import R2REnv
    from .agent.policy import VLNPolicy, random_state_dict
    from .agent.pretrain import extract_policy_params
    from .agent.rollout import evaluate
    from .agent.update import make_train_state
    from .parallel import multihost
    from .parallel.mesh import make_mesh, replicate
    from .runtime import resolve_device, set_fp32_precision
    from .utils.checkpoint import latest_step, model_file, save_model

    device = multihost.initialize_if_needed(resolve_device(args.device))
    mesh = make_mesh((args.mesh, 1)) if args.mesh else None
    if mesh is not None and args.update_batch % args.mesh:
        raise SystemExit(f"--update-batch {args.update_batch} must divide "
                         f"by --mesh {args.mesh}")
    writer = multihost.process_index() == 0
    os.makedirs(args.work_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    setup = build_vln_setup(args)
    cfg, episodes, objects = setup.cfg, setup.episodes, setup.objects
    set_fp32_precision(cfg.dtype)
    env = R2REnv(episodes, setup.graphs, setup.ver,
                 max_nodes=cfg.max_nodes, objects=objects)
    policy = VLNPolicy(cfg, grounding=objects is not None)
    if args.init_from_pretrain:
        # the pretrained checkpoint supersedes the --text-init /
        # --crossmodal-init grafts (pretraining started from them); the
        # flags still set the architecture it must match
        if args.text_init or args.crossmodal_init:
            print("note: --init-from-pretrain supersedes the --text-init/"
                  "--crossmodal-init param grafts; the flags only pin the "
                  "matching architecture (pass the same ones used for "
                  "pretrain_vln)")
        pdir = os.path.abspath(args.init_from_pretrain)
        pstep = latest_step(pdir)
        if pstep is None:
            raise SystemExit(f"no checkpoint under {pdir}")
        policy.load_state_dict(extract_policy_params(torch.load(
            model_file(pdir), map_location="cpu", weights_only=True)),
            strict=True)
        print(f"init-from-pretrain: {pdir} step {pstep}")
    else:
        policy.load_state_dict(random_state_dict(policy, args.seed),
                               strict=True)
        graft_pretrained(policy, cfg, setup.text_params, setup.xmodal)
    policy = policy.to(device).eval()   # dropout off, as in JAX
    if mesh is not None:
        replicate(mesh, policy)
    n_params = sum(p.numel() for p in policy.parameters())
    print(f"policy params: {n_params / 1e6:.2f}M, episodes: "
          f"{len(episodes)}")

    state = make_train_state(policy, args.lr)
    generator = torch.Generator(device=device).manual_seed(args.seed + 7)
    updates = dagger_updates(
        policy, state, env, cfg, rng, generator, device,
        sample_prob=args.sample_prob, dagger_ramp=args.dagger_ramp,
        episode_batch=args.episode_batch, update_batch=args.update_batch,
        mesh=mesh)

    metrics: Dict[str, float] = {}
    t0 = time.perf_counter()
    step, losses = 0, []
    with open(os.path.join(args.work_dir, "vln_log.jsonl")
              if writer else os.devnull, "a") as logf:
        while step < args.steps:
            step, loss, _ = next(updates)
            losses.append(float(loss))
            if (step // args.update_batch) % 5 == 0:
                avg = float(np.mean(losses[-5:]))
                print(f"step {step}: nll={avg:.4f} "
                      f"({(time.perf_counter() - t0) / step:.2f}s/step)")
                logf.write(json.dumps(dict(step=step, loss=avg)) + "\n")
                logf.flush()
            if (step % args.eval_interval < args.update_batch
                    or step >= args.steps):
                metrics = evaluate(policy, env, cfg, limit=args.eval_limit)
                metrics["step"] = step
                print("eval:", {k: round(float(v), 3)
                                for k, v in metrics.items()})
                logf.write(json.dumps(metrics) + "\n")
                logf.flush()

    if writer:
        save_model(os.path.join(args.work_dir, "ckpt"), step, policy)
        print(f"saved policy params at step {step}")
    print("done")
    return metrics


if __name__ == "__main__":
    main()
