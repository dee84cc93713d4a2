"""Training CLI, ``python -m vln_ver_tpu_torch.train`` (PyTorch port of
``tools/train.py``).

One eager train step a batch (forward in ``train()`` mode, Hungarian
matching, losses, backward, clip, AdamW), checkpoints under
``<work-dir>/ckpt/step_NNNNNNNN``, the reference's mmcv-style config
files driving everything.

Usage:
  python -m vln_ver_tpu_torch.train configs/verformer/vocc.py \
      --work-dir work_dirs/vocc [--synthetic] [--max-steps N] \
      [--batch-size B] [--device cuda|cpu] [--resume]

SIGTERM finishes the step in flight, writes a synchronous checkpoint and
exits 0; ``--resume`` then continues at the same step and data position.
A ``TensorboardLoggerHook`` in the config's ``log_config`` also writes the
logged scalars (``train/<key>``, and ``val/<key>`` of the eval ticks) as
Tensorboard events under ``<work-dir>/tf_logs``, as ``tools/train.py``
does.

Data-parallel over several cards, one process each (torchrun's
environment), optionally with each viewpoint's cameras split over V:
  torchrun --nproc-per-node N -m vln_ver_tpu_torch.train CONFIG ... \
      --mesh D[,V]
Each global batch of ``--batch-size`` (which must divide by D) is split
over the data ranks; the step equals the one-process step on the global
batch (``train.step``).  Rank 0 writes the checkpoints and the log; every
rank restores.  ``--mesh S,D,V`` is the multi-slice grid
(``parallel.mesh.make_multislice_mesh``: S nodes, the batch split over
S x D); ``--tp-model M`` shards the parameters and AdamW moments over M
ranks (``parallel.tensor``) on a (D, V, M) grid, D from ``--mesh D[,V]``
or the world over V x M.  Checkpoints are the replicated state's under
every grid.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.train")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   help="dotted config overrides: key.subkey=value")
    p.add_argument("--work-dir", default="work_dirs/default")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset if ann files missing")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--log-interval", type=int, default=None,
                   help="default: the config's log_config.interval "
                        "(vocc.py:186), else 50")
    p.add_argument("--ckpt-interval", type=int, default=1000)
    p.add_argument("--async-ckpt", action="store_true",
                   help="write checkpoints on a background thread; the "
                        "host snapshot is still taken at the save step")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="run val-split eval every N steps (0 = off)")
    p.add_argument("--eval-limit", type=int, default=32,
                   help="cap eval-tick viewpoints (0 = full val split)")
    p.add_argument("--occ-thresholds", type=float, nargs="+",
                   default=[0.25])
    p.add_argument("--save-best", default=None,
                   help="eval metric to track (e.g. miou, mAP_0.25); the "
                        "best checkpoint is kept under ckpt_best/")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder layers in the backward "
                        "(torch.utils.checkpoint); the same numbers")
    p.add_argument("--mesh", type=str, default=None,
                   help="'D[,V]': data x view process grid over the world "
                        "(torchrun); default D = the world, V = 1; 'S,D,V': "
                        "the multi-slice grid of S nodes")
    p.add_argument("--tp-model", type=int, default=1,
                   help="M > 1: shard the parameters and AdamW moments "
                        "over M ranks of a (data, view, model) grid")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def _best_key(metrics: dict, name: str, thresholds) -> str | None:
    """``--save-best`` resolved against the eval metrics: multi-threshold
    evals suffix keys with ``@thr``, and the first listed threshold wins."""
    if name in metrics:
        return name
    first = f"{name}@{thresholds[0]:.2f}"
    cands = [k for k in metrics if k.startswith(name + "@")]
    return first if first in metrics else (cands[0] if cands else None)


def train_mesh(arg, tp_model: int):
    """The grid of ``--mesh`` and ``--tp-model`` (tools/train.py:139-152):
    with ``tp_model > 1`` the (data, view, model) grid, D the first value
    of ``--mesh`` or the world over V x M; a 3-value ``--mesh`` the
    multi-slice grid; else ``parse_eval_mesh`` (None for one process
    without the flag)."""
    from ..parallel import multihost
    from ..parallel.mesh import make_multislice_mesh, parse_eval_mesh
    from ..parallel.tensor import make_tp_mesh
    shape = tuple(int(x) for x in arg.split(",")) if arg else None
    if tp_model > 1:
        if shape and len(shape) > 2:
            raise ValueError(f"--tp-model takes --mesh 'D[,V]', got {arg!r}")
        view = shape[1] if shape and len(shape) > 1 else 1
        world = multihost.process_count()
        if shape is None and world % (view * tp_model):
            raise ValueError(f"--tp-model {tp_model}: the world of {world} "
                             f"processes does not divide by view x model = "
                             f"{view * tp_model}")
        data = shape[0] if shape else world // (view * tp_model)
        return make_tp_mesh(data, tp_model, view)
    if shape and len(shape) == 3:
        return make_multislice_mesh(*shape)
    return parse_eval_mesh(arg)


def main(argv=None) -> dict:
    """Runs the training; returns the metrics of the last step taken."""
    args = parse_args(argv)
    if args.save_best and 0 < args.eval_limit < 256:
        print(f"WARNING: --save-best {args.save_best!r} with --eval-limit "
              f"{args.eval_limit}: best-checkpoint selection on a small "
              "eval subset is noise-driven; pass --eval-limit 0 for real "
              "runs.")
    import numpy as np

    from ..config.api import (apply_cfg_options, build_train_config,
                              build_ver_config, dataset_kwargs, load_config)
    from ..data.mp3d import MP3DDataset, iterate_batches
    from ..data.synthetic import make_synthetic_dataset
    from ..models.detector import build_model
    from ..parallel import multihost
    from ..parallel.mesh import replicate, shard_views
    from ..parallel.tensor import gathered, shard_state, tp_fraction
    from ..runtime import resolve_device
    from ..utils.checkpoint import (AsyncSaver, latest_step, restore_state,
                                    save_state)
    from .feed import staged_batches, to_device
    from .state import create_train_state, param_count
    from .step import make_train_step

    device = multihost.initialize_if_needed(resolve_device(args.device))
    mesh = train_mesh(args.mesh, args.tp_model)
    # rank 0 writes the checkpoints and the logs
    writer = multihost.process_index() == 0
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    log_cfg = cfg.get("log_config", {}) or {}
    ver = build_ver_config(cfg, **({"remat_encoder": True}
                                   if args.remat else {}))
    os.makedirs(args.work_dir, exist_ok=True)

    ds_kw = dataset_kwargs(cfg, "train")
    ann, root = ds_kw["ann_file"], ds_kw["data_root"]
    if not os.path.exists(ann):
        if not args.synthetic:
            raise FileNotFoundError(
                f"{ann} not found; pass --synthetic to generate data")
        os.makedirs(root or "data/mp3d", exist_ok=True)
        ann = multihost.run_once(lambda: make_synthetic_dataset(
            root or "data/mp3d", num_scans=2, viewpoints_per_scan=4,
            num_cams=ver.num_cams, feat_hw=ver.feat_h,
            feat_dim=ver.in_channels,
            occ_dims=(ver.occ_zdim, ver.occ_ydim, ver.occ_xdim),
            pc_range=ver.pc_range))
    dataset = MP3DDataset(ann, root, voxel_num=ver.voxel_num,
                          occupancy_classes=ver.occupancy_classes,
                          num_cams=ver.num_cams, feat_hw=ver.feat_h)

    batch_size = args.batch_size or max(
        cfg.get("data", {}).get("samples_per_gpu", 1), 1)
    if len(dataset) < batch_size:
        raise SystemExit(f"dataset ({len(dataset)} samples) smaller than "
                         f"--batch-size {batch_size} (drop_last would "
                         "yield zero batches per epoch)")
    steps_per_epoch = len(dataset) // batch_size
    tc = build_train_config(cfg, steps_per_epoch)
    total_steps = args.max_steps or tc.total_steps
    d = 1 if mesh is None else mesh.data_size
    if batch_size % d:
        raise SystemExit(f"--batch-size {batch_size} not divisible by the "
                         f"mesh's data size {d}")
    local_batch = batch_size // d

    model = build_model(ver, device, seed=args.seed)
    if mesh is not None:
        replicate(mesh, model).shard_views(mesh.views)
    state = create_train_state(model, tc)
    print(f"model params: {param_count(model) / 1e6:.1f}M; device: "
          f"{device}; batch: {batch_size}; steps/epoch: {steps_per_epoch}")

    start_step = 0
    ckpt_dir = os.path.abspath(os.path.join(args.work_dir, "ckpt"))
    if args.resume:
        found = latest_step(ckpt_dir)
        if found is not None:
            restore_state(ckpt_dir, found, state)
            start_step = state.step
            print(f"resumed from step {start_step}")
    if args.tp_model > 1:
        shard_state(mesh, state)
        print(f"mesh {dict(zip(mesh.axis_names, mesh.shape))}: "
              f"{tp_fraction(state, mesh):.4f} of the parameters sharded")
    step_fn = make_train_step(ver, tc, mesh)
    log_interval = args.log_interval or int(log_cfg.get("interval", 50))
    # the reference's log_config hooks (vocc.py:286-291): the jsonl log
    # and stdout stand for its TextLoggerHook; a TensorboardLoggerHook
    # turns on the event writer, on rank 0
    tb_writer = None
    if writer and any("Tensorboard" in str(h.get("type", ""))
                      for h in log_cfg.get("hooks", []) or []
                      if isinstance(h, dict)):
        from ..utils.tensorboard import SummaryWriter
        tb_writer = SummaryWriter(os.path.join(args.work_dir, "tf_logs"))
        print(f"tensorboard events -> {tb_writer.path}")

    # checkpoint metadata (the reference's tools/train.py embeds the config
    # text and CLASSES in its checkpoints)
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(args.config) as f:
        cfg_text = f.read()
    if writer:
        with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
            json.dump({"config": cfg_text,
                       "CLASSES": list(cfg.get("class_names", ())
                                       or cfg.get("data", {}).get(
                                           "train", {}).get("classes", ()))},
                      f)

    saver = AsyncSaver() if args.async_ckpt and writer else None

    def save(step_dir_root, step_no, via=None):
        """Every rank calls this: a sharded state is gathered, then rank 0
        writes it (``via`` an AsyncSaver, else synchronously)."""
        with gathered(state):
            if via is not None:
                via.save(step_dir_root, step_no, state)
            elif writer:
                save_state(step_dir_root, step_no, state)
    # preemption: finish the step in flight, write a synchronous
    # checkpoint and exit 0, so that --resume continues from there
    got_signal: list = []
    prev_handler = signal.signal(signal.SIGTERM,
                                 lambda sig, frame: got_signal.append(sig))
    # --resume continues the data order too: the epoch (shuffle seed) and
    # the position in it follow from the restored step, exactly, because
    # drop_last makes every epoch steps_per_epoch batches long
    epoch, skip = divmod(start_step, steps_per_epoch)
    step = start_step
    metrics: dict = {}
    best = float("-inf")
    val_ds, val_kw = None, {}
    t0 = time.perf_counter()
    try:
        with open(os.path.join(args.work_dir, "train_log.jsonl")
                  if writer else os.devnull, "a") as log:
            while step < total_steps:
                # a fixed shuffle per epoch, drop_last
                order = np.random.default_rng(args.seed + epoch).permutation(
                    len(dataset))[:steps_per_epoch * batch_size]
                order = order[skip * batch_size:]
                skip = 0
                epoch += 1
                # this data rank's rows of every global batch
                lo = 0 if mesh is None else mesh.data_index * local_batch
                order = order.reshape(-1, batch_size)[
                    :, lo:lo + local_batch].reshape(-1)
                for batch in staged_batches(
                        iterate_batches(dataset, local_batch, indices=order),
                        lambda b: to_device(b if mesh is None else
                                            shard_views(mesh, b), device)):
                    if step >= total_steps:
                        break
                    out = step_fn(state, batch, args.seed + 1)
                    step += 1
                    if got_signal:
                        if saver is not None:
                            saver.wait()
                        save(ckpt_dir, step)
                        print(f"signal {got_signal[0]}: checkpoint saved at "
                              f"step {step}; resume with --resume")
                        return {k: float(v) for k, v in out.items()}
                    if step % log_interval == 0 or step == total_steps:
                        metrics = {k: float(v) for k, v in out.items()}
                        if metrics["sca_overflow"] > 0:
                            save(ckpt_dir, step)
                            raise SystemExit(
                                f"sca_query_capacity overflow at step {step}"
                                f": {int(metrics['sca_overflow'])} visible "
                                "queries beyond capacity in the worst camera"
                                " slot were dropped (checkpoint saved)")
                        metrics.update(
                            step=step, lr=state.schedule(step),
                            sec_per_step=(time.perf_counter() - t0)
                            / max(step - start_step, 1))
                        log.write(json.dumps(metrics) + "\n")
                        log.flush()
                        if tb_writer is not None:
                            tb_writer.add_scalars(
                                {f"train/{k}": v for k, v in metrics.items()},
                                step)
                            tb_writer.flush()
                        print(f"step {step}: loss={metrics['loss']:.4f} "
                              f"cls={metrics.get('loss_cls', 0):.4f} "
                              f"bbox={metrics.get('loss_bbox', 0):.4f} "
                              f"occ={metrics.get('loss_occupancy', 0):.4f} "
                              f"({metrics['sec_per_step']:.2f}s/step)")
                    if step % args.ckpt_interval == 0 or step == total_steps:
                        save(ckpt_dir, step, saver)
                    if args.eval_interval and (step % args.eval_interval == 0
                                               or step == total_steps):
                        from ..evaluation.runner import evaluate_model
                        if val_ds is None:
                            val_kw = (dataset_kwargs(cfg, "val")
                                      or dataset_kwargs(cfg, "test") or {})
                            if os.path.exists(val_kw.get("ann_file", "")):
                                val_ds = MP3DDataset(
                                    val_kw["ann_file"], val_kw["data_root"],
                                    voxel_num=ver.voxel_num,
                                    occupancy_classes=ver.occupancy_classes,
                                    num_cams=ver.num_cams,
                                    feat_hw=ver.feat_h)
                        if val_ds is None:
                            continue
                        # the full parameters; the rows split over the
                        # batch axes alone, so model and view ranks count
                        # each viewpoint once
                        with gathered(state, moments=False):
                            em = evaluate_model(
                                model, val_ds,
                                occ_thresholds=tuple(args.occ_thresholds),
                                limit=args.eval_limit or None,
                                classes=tuple(val_kw.get("classes", ())),
                                batch_size=d, mesh=mesh)
                        keep = {k: round(float(v), 4) for k, v in em.items()
                                if k.startswith(("mAP", "mAR", "miou", "iou",
                                                 "occ_"))}
                        keep["step"] = step
                        print("eval:", keep)
                        log.write(json.dumps(keep) + "\n")
                        log.flush()
                        if tb_writer is not None:
                            tb_writer.add_scalars(
                                {f"val/{k}": v for k, v in keep.items()},
                                step)
                            tb_writer.flush()
                        key = (_best_key(em, args.save_best,
                                         args.occ_thresholds)
                               if args.save_best else None)
                        if args.save_best and key is None:
                            print(f"warning: --save-best {args.save_best!r} "
                                  f"matches no eval metric {sorted(keep)}")
                        if key is not None and float(em[key]) > best:
                            best = float(em[key])
                            save(os.path.join(args.work_dir, "ckpt_best"),
                                 step)
                            print(f"new best {args.save_best}={best:.4f} at "
                                  f"step {step}")
        if saver is not None:
            saver.wait()
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        if tb_writer is not None:
            tb_writer.close()
        dataset.close()
        if val_ds is not None:
            val_ds.close()
    print("done")
    return metrics
