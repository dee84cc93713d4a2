"""Training-step throughput on one card (PyTorch port of
``tools/bench_train.py``).

    python -m vln_ver_tpu_torch.bench_train [--cams 36] [--batch 2]
        [--iters 4] [--max-gt 16] [--remat] [--qcap N] [--tiny]
        [--mode step|grad|fwd] [--e2e [--steps 12] [--volumes 16]]
        [--device cuda|cpu]

Times the train step of ``VERConfig(num_cams=--cams, dtype=bfloat16)``
(random weights from seed 0, ``TrainConfig(warmup_steps=10,
total_steps=1000)``) on the JAX tool's synthetic batch: the example inputs
of ``vln_ver_tpu_torch.bench``, ``--max-gt`` boxes of which about 60 % are
valid, and a random occupancy grid.  ``--mode step`` is the whole update
(forward, matching and losses, backward, clip and AdamW;
``train.step.make_train_step``), ``grad`` the forward and backward with
the gradient's norm, ``fwd`` the losses alone; differencing the three
isolates the backward and the optimizer.  Each is the least of three
samples of ``--iters`` back-to-back steps between CUDA events
(``utils.bench.event_time_stats``).

``--e2e`` times the real loop instead, on an on-disk synthetic dataset of
``--volumes`` viewpoints (HDF5: needs h5py): ``loader`` (the prefetching
reads and collate alone), ``serial`` (those, the upload and the step on
one thread) and ``overlapped`` (the upload staged one batch ahead on a
thread, ``train.feed.staged_batches``, as ``train`` runs it).  The
dataset pads its boxes to its own 32 (``data.mp3d.MAX_GT``).

``--tiny`` shrinks the model's widths: a smoke run of the modes, not a
measurement.  Prints one JSON line with the JAX tool's keys, the last
step's loss (``last_loss``) and the card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.bench_train")
    p.add_argument("--cams", type=int, default=36)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--max-gt", type=int, default=16)
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder layers in the backward")
    p.add_argument("--qcap", type=int, default=0,
                   help="sca_query_capacity: the capacity-bounded sparse "
                        "lift (0 = dense)")
    p.add_argument("--tiny", action="store_true",
                   help="shrunken model widths: a smoke run of the modes, "
                        "not a measurement")
    p.add_argument("--mode", default="step", choices=["step", "grad", "fwd"],
                   help="step = forward+backward+AdamW; grad = forward+"
                        "backward only; fwd = losses only")
    p.add_argument("--e2e", action="store_true",
                   help="time the real training loop on an on-disk "
                        "synthetic dataset, with loader / serial / "
                        "overlapped attribution")
    p.add_argument("--steps", type=int, default=12,
                   help="--e2e: timed steps per measurement")
    p.add_argument("--volumes", type=int, default=16,
                   help="--e2e: on-disk dataset size (viewpoints)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def model_config(args):
    from .models import VERConfig
    if args.tiny:
        return VERConfig(num_cams=args.cams, dtype=torch.bfloat16,
                         bev_z=2, bev_h=4, bev_w=4,
                         occupancy_size=(1.5, 1.5, 0.4375),
                         feat_h=4, feat_w=4,
                         embed_dims=32, in_channels=32, ffn_dim=64,
                         occ_dims=16, encoder_layers=1, decoder_layers=2,
                         num_query=12)
    return VERConfig(num_cams=args.cams, dtype=torch.bfloat16,
                     remat_encoder=args.remat,
                     sca_query_capacity=args.qcap)


def synthetic_batch(cfg, batch: int, max_gt: int) -> dict:
    """The JAX tool's batch, as numpy: example inputs, ``max_gt`` unit
    boxes centred uniformly in [-4, 4]^2 with random labels, each valid
    with probability 0.6, and random occupancy labels (empty included)."""
    from .bench import example_inputs

    rng = np.random.default_rng(0)
    feats, w2p, shift = example_inputs(cfg, batch=batch)
    gt_boxes = np.zeros((batch, max_gt, 9), np.float32)
    gt_boxes[:, :, 3:6] = 1.0
    gt_boxes[:, :, 0:2] = rng.uniform(-4, 4, (batch, max_gt, 2))
    return {
        "features": feats, "world2pixel": w2p, "origin_shift": shift,
        "gt_boxes": gt_boxes,
        "gt_labels": rng.integers(0, cfg.num_classes,
                                  (batch, max_gt)).astype(np.int32),
        "gt_valid": rng.uniform(size=(batch, max_gt)) < 0.6,
        "occ_dense": rng.integers(0, cfg.occupancy_classes + 1,
                                  (batch, cfg.voxel_num)).astype(np.int32),
    }


def make_step(mode: str, cfg, tc, state):
    """``step(batch, i) -> (scalar, loss)`` for iteration ``i`` of
    ``mode``: the scalar is what the JAX tool accumulates (``step``: the
    train step's loss plus its gradient norm; ``grad``: the loss plus the
    norm of a backward with no update; ``fwd``: the loss), on the
    device."""
    from .train.objective import compute_losses
    from .train.state import global_norm
    from .train.step import make_train_step, step_seed

    train_step = make_train_step(cfg, tc)
    model = state.model
    dev = next(model.parameters()).device
    devices = [dev.index] if dev.type == "cuda" else []

    def loss_of(batch, i):
        model.train()
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(step_seed(1, i))
            outs = model(batch["features"], batch["world2pixel"],
                         batch["origin_shift"])
            return sum(compute_losses(cfg, outs, batch,
                                      matcher=tc.matcher).values())

    def step(batch, i):
        if mode == "step":
            m = train_step(state, batch, 1)
            return m["loss"] + m["grad_norm"], m["loss"]
        if mode == "grad":
            params = [p for p in model.parameters() if p.requires_grad]
            loss = loss_of(batch, i)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            loss = loss.detach()
            return loss + global_norm([g for g in grads
                                       if g is not None]), loss
        with torch.no_grad():
            loss = loss_of(batch, i)
        return loss, loss

    return step


def run_e2e(args, cfg, tc, state, device) -> dict:
    """The real loop's rates on an on-disk synthetic dataset (see the
    module docstring)."""
    from .data.mp3d import MP3DDataset, iterate_batches
    from .data.synthetic import make_synthetic_dataset
    from .train.feed import staged_batches, to_device
    from .train.step import make_train_step

    try:
        import h5py  # noqa: F401
    except ImportError:
        raise SystemExit("--e2e reads an HDF5 dataset and h5py is not "
                         "installed: install it, or run without --e2e") \
            from None
    root = os.path.join(
        REPO, ".bench_data",
        f"torch_train_c{cfg.num_cams}_f{cfg.feat_h}x{cfg.in_channels}"
        f"_o{cfg.occ_zdim}x{cfg.occ_ydim}x{cfg.occ_xdim}_n{args.volumes}")
    ann = os.path.join(root, "mp3d_trainval.pkl")
    if not os.path.exists(ann):
        os.makedirs(root, exist_ok=True)
        ann = make_synthetic_dataset(
            root, num_scans=1, viewpoints_per_scan=args.volumes,
            num_cams=cfg.num_cams, feat_hw=cfg.feat_h,
            feat_dim=cfg.in_channels,
            occ_dims=(cfg.occ_zdim, cfg.occ_ydim, cfg.occ_xdim),
            pc_range=cfg.pc_range)
    dataset = MP3DDataset(ann, root, voxel_num=cfg.voxel_num,
                          occupancy_classes=cfg.occupancy_classes,
                          num_cams=cfg.num_cams, feat_hw=cfg.feat_h)
    b = args.batch
    if len(dataset) < b:
        raise SystemExit(f"--volumes {args.volumes} < --batch {b}")
    step_fn = make_train_step(cfg, tc)
    upload_cast = cfg.dtype if cfg.dtype.itemsize < 4 else None

    def batches(n):
        """n train batches in the loop's epoch order (wrapping, whole
        batches only)."""
        done, epoch = 0, 0
        per_epoch = len(dataset) // b * b
        while done < n:
            order = np.random.default_rng(epoch).permutation(
                len(dataset))[:per_epoch]
            for batch in iterate_batches(dataset, b, indices=order):
                if done == n:
                    return
                done += 1
                yield batch
            epoch += 1

    def place(batch):
        # the JAX tool's upload: the features cast to the compute dtype on
        # the host first (the encoder's first touch is that cast)
        feats = torch.from_numpy(np.ascontiguousarray(batch["features"]))
        out = to_device({k: v for k, v in batch.items()
                         if k != "features"}, device)
        if upload_cast is not None:
            feats = feats.to(upload_cast)
        if device.type == "cuda":
            feats = feats.pin_memory().to(device, non_blocking=True)
        out["features"] = feats
        return out

    def timed_loop(n, overlap):
        it = (staged_batches(batches(n), place) if overlap
              else (place(x) for x in batches(n)))
        t0 = time.perf_counter()
        metrics = None
        for batch in it:
            metrics = step_fn(state, batch, 1)
        loss = float(metrics["loss"])   # waits for the whole chain
        return n / (time.perf_counter() - t0), loss

    try:
        _, loss = timed_loop(2, overlap=True)   # warm, untimed
        if loss != loss:
            raise SystemExit("NaN loss in the e2e bench")
        t0 = time.perf_counter()
        for _ in batches(args.steps):
            pass
        loader_rate = args.steps / (time.perf_counter() - t0)
        serial_rate, _ = timed_loop(args.steps, overlap=False)
        overlap_rate, loss = timed_loop(args.steps, overlap=True)
    finally:
        dataset.close()
    return {
        "metric": "train_e2e_steps_per_sec",
        "value": round(overlap_rate, 4), "unit": "steps/s",
        "samples_per_sec": round(overlap_rate * b, 3),
        "serial_steps_per_sec": round(serial_rate, 4),
        "loader_batches_per_sec": round(loader_rate, 4),
        "overlap_speedup": round(overlap_rate / serial_rate, 3),
        "batch": b, "cams": args.cams, "steps": args.steps,
        "upload": str(upload_cast).split(".")[-1] if upload_cast
        else "float32",
        "last_loss": loss,
    }


def run(args) -> dict:
    """The bench line for parsed ``args``, with the timing's ``calls``
    (steps taken, warm-up included) under ``steps_run``."""
    from .models import build_model
    from .runtime import resolve_device
    from .train.feed import to_device
    from .train.state import TrainConfig, create_train_state
    from .utils.bench import card_name, event_time_stats

    device = resolve_device(args.device)
    cfg = model_config(args)
    model = build_model(cfg, device, seed=0)
    tc = TrainConfig(warmup_steps=10, total_steps=1000)
    state = create_train_state(model, tc)
    if args.e2e:
        line = run_e2e(args, cfg, tc, state, device)
        line["card"] = card_name(device)
        return line

    batch = to_device(synthetic_batch(cfg, args.batch, args.max_gt), device)
    step = make_step(args.mode, cfg, tc, state)
    it = itertools.count()
    last = []

    def one():
        acc, loss = step(batch, next(it))
        last[:] = [loss]
        return acc

    stats = event_time_stats(one, device, args.iters, warmup=2, repeats=3)
    dt = stats["sec_per_iter"]
    return {
        "metric": "train_step_seconds", "value": round(dt, 4),
        "unit": "s/step", "samples_per_sec": round(args.batch / dt, 3),
        "batch": args.batch, "cams": args.cams, "mode": args.mode,
        "spread": round(stats["spread"], 4),
        "last_loss": float(last[0]), "steps_run": stats["calls"],
        "card": card_name(device),
    }


def main(argv=None) -> dict:
    line = run(parse_args(argv))
    print(json.dumps(line), flush=True)
    if line["last_loss"] != line["last_loss"]:
        sys.exit("the last step's loss is NaN")
    return line


if __name__ == "__main__":
    main()
