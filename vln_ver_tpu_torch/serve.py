"""VER serving: a long-running server that keeps the model resident and
answers volume (and occupancy) requests in micro-batches (PyTorch port of
``tools/serve_ver.py``).

Usage:
  python -m vln_ver_tpu_torch.serve configs/verformer/get_occ.py \\
      --queue q [--batch-max 8] [--poll-ms 50] [--occupancy] \\
      [--checkpoint X.pth] [--images [--vit-checkpoint V.pth] \\
       [--hf-prefix P] [--vit-patch-size 16] [--vit-layers 12] \\
       [--vit-heads 12]] [--max-requests N] [--device cuda|cpu] \\
      [--cfg-options key=value ...]

The queue protocol is the JAX tool's, byte for byte on disk, so a client
of either server talks to both:

* a request is ``<queue>/in/<id>.npz`` holding ``features`` (num_cams,
  feat_h, feat_w, C) fp32 or, with ``--images``, ``images`` (num_cams, H,
  W, 3) uint8 views, plus ``world2pixel`` (num_cams, 4, 4) and
  ``origin_shift`` (3,).  Clients write a dotfile and ``os.replace`` it
  to ``<id>.npz``; a request that fails to parse while fresh is pushed
  back to the inbox as a possible half-write;
* the response is ``<queue>/out/<id>.npz`` with ``volume`` (C, Z, H, W)
  fp32 and, with ``--occupancy``, ``occupancy`` (voxel_num,) int32
  labels; a malformed request gives ``<queue>/out/<id>.error.txt``;
  ``<queue>/in/STOP`` stops the server;
* requests are claimed by a rename into ``<queue>/.claimed.{host}-{pid}``,
  so several servers can drain one inbox; a claimed batch is re-touched
  every 60 s while it runs, and claims of a dead server (a dead pid on
  this host, or untouched for 300 s) are swept back to the inbox.

Feature and image requests batch separately; each group is padded to
``--batch-max`` by repeating its last row (the pad rows are dropped), so
every batch launches the forward kernel at one shape, with one launch
plan.  ``--checkpoint`` takes a reference-format ``.pth``, a step
directory or a train checkpoint directory (its latest step); without it
the weights are random from seed 0, and without ``--vit-checkpoint`` the
ViT's are random from seed 1 (a smoke run only).
"""

from __future__ import annotations

import argparse
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch


class _ClaimKeepAlive:
    """Re-touch claimed request files from a daemon thread while the
    forward runs, so that other servers' orphan sweeps never take a live
    server's batch for a dead one's.  ``stop()`` joins the thread."""

    def __init__(self, paths, interval_s: float = 60.0):
        self._paths = list(paths)
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _touch(self):
        for p in self._paths:
            try:
                os.utime(p)
            except OSError:
                pass  # already reclaimed or served

    def _run(self):
        while not self._stop.wait(self._interval):
            self._touch()

    def start(self):
        # the stale clock starts at the claim, not at the client's write
        self._touch()
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vln_ver_tpu_torch.serve")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--queue", required=True,
                   help="queue dir; requests in <queue>/in, responses in "
                        "<queue>/out")
    p.add_argument("--batch-max", type=int, default=8,
                   help="micro-batch capacity (one launch shape)")
    p.add_argument("--poll-ms", type=int, default=50)
    p.add_argument("--occupancy", action="store_true",
                   help="also decode and return dense occupancy labels")
    p.add_argument("--max-requests", type=int, default=None,
                   help="exit after serving N requests (tests)")
    p.add_argument("--images", action="store_true",
                   help="also accept image requests ('images' (num_cams, "
                        "H, W, 3) uint8): the ViT frontend and the lift run "
                        "in one call; the two kinds batch separately")
    p.add_argument("--vit-checkpoint", default=None,
                   help="HF ViTModel state dict for --images (omitted: "
                        "random weights, smoke only)")
    p.add_argument("--hf-prefix", default="")
    p.add_argument("--vit-patch-size", type=int, default=16)
    p.add_argument("--vit-layers", type=int, default=12)
    p.add_argument("--vit-heads", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def _claim(inbox: str, claimed_dir: str, limit: int):
    """Claim up to ``limit`` pending requests by renaming them into this
    server's claimed dir, oldest name first; a lost race is skipped, and
    dotfiles (client write-temps) are never claimed.  The claimed dir is
    made again on every call: a peer's sweep may have removed it."""
    os.makedirs(claimed_dir, exist_ok=True)
    try:
        names = sorted(f for f in os.listdir(inbox)
                       if f.endswith(".npz") and not f.startswith("."))
    except FileNotFoundError:
        return []
    got = []
    for name in names[: 4 * limit]:
        dst = os.path.join(claimed_dir, name)
        try:
            os.rename(os.path.join(inbox, name), dst)
        except OSError:
            continue
        got.append(dst)
        if len(got) >= limit:
            break
    return got


def _claim_host() -> str:
    return socket.gethostname().replace("-", "_")


def _sweep_orphans(queue: str, inbox: str, max_age_s: float = 300.0):
    """Return requests stranded in dead servers' ``.claimed.{host}-{pid}``
    dirs to the inbox: a claim of this host whose pid is dead, or any
    claim untouched for ``max_age_s`` (a live server re-touches its claims
    every 60 s).  Another host's pid cannot be probed here, so its claims
    go back on staleness alone; only a proven-dead owner's emptied dir is
    removed."""
    me = _claim_host()
    for name in os.listdir(queue):
        if not name.startswith(".claimed."):
            continue
        d = os.path.join(queue, name)
        host, _, pidstr = name[len(".claimed."):].rpartition("-")
        try:
            pid = int(pidstr)
        except ValueError:
            pid = -1
        if pid == os.getpid() and host in ("", me):
            continue  # our own claims in flight
        alive = None
        if pid > 0 and host in ("", me):
            try:
                os.kill(pid, 0)
                alive = True
            except OSError:
                alive = False
        try:
            names = list(os.listdir(d))
        except OSError:
            continue  # the owner finished its batch
        for f in names:
            path = os.path.join(d, f)
            try:
                stale = (time.time() - os.path.getmtime(path)) > max_age_s
            except OSError:
                continue  # served or removed meanwhile
            if alive is False or stale:
                try:
                    os.rename(path, os.path.join(inbox, f))
                except OSError:
                    pass
        if alive is False and pid > 0:
            try:
                os.rmdir(d)  # only once emptied
            except OSError:
                pass


def _load_request(path: str, ver, image_size: int, images: bool):
    """(kind, x, world2pixel, origin_shift) of one request file; raises
    ValueError on anything the server cannot serve."""
    with np.load(path) as z:
        if "images" in z:
            if not images:
                raise ValueError("image request but server started without "
                                 "--images")
            kind = "images"
            x = np.asarray(z["images"], np.uint8)
            expect = (ver.num_cams, image_size, image_size, 3)
        else:
            kind = "features"
            x = np.asarray(z["features"], np.float32)
            expect = (ver.num_cams, ver.feat_h, ver.feat_w, ver.in_channels)
        w = np.asarray(z["world2pixel"], np.float32)
        s = np.asarray(z["origin_shift"], np.float32)
    if x.shape != expect or w.shape != (ver.num_cams, 4, 4) \
            or s.shape != (3,):
        raise ValueError(f"bad shapes {x.shape} {w.shape} {s.shape}, want "
                         f"{expect} {(ver.num_cams, 4, 4)} (3,)")
    return kind, x, w, s


def _reject(path: str, inbox: str, outbox: str, err: Exception) -> None:
    """A request that did not load: gone (a peer's sweep took it), pushed
    back when fresh (a possible half-write), else an error file."""
    if not os.path.exists(path):
        return
    try:
        fresh = (time.time() - os.path.getmtime(path)) < 2.0
    except OSError:
        fresh = False
    if fresh:
        try:
            os.rename(path, os.path.join(inbox, os.path.basename(path)))
            return
        except OSError:
            pass
    rid = os.path.basename(path)[:-4]
    with open(os.path.join(outbox, f"{rid}.error.txt"), "w") as fh:
        fh.write(repr(err))
    try:
        os.remove(path)
    except OSError:
        pass


def make_forward(model, ver, vit=None, occupancy: bool = False):
    """``forward(inputs, w2p, shift) -> (bev (B, bev_num, C), occupancy
    labels (B, voxel_num) int32 or None)`` under ``inference_mode``;
    ``inputs`` are features, or with ``vit`` uint8 views."""
    from .get_occ import make_bev_only
    from .models.vit import vit_feature_frontend
    from .occupancy import decode_occupancy
    from .runtime import fp32_precision

    if not occupancy:
        bev_only = make_bev_only(model, vit)

        def forward(inputs, w2p, shift):
            return bev_only(inputs, w2p, shift)[0], None
        return forward

    @torch.inference_mode()
    def forward(inputs, w2p, shift):
        feats = inputs if vit is None else vit_feature_frontend(vit, inputs)
        with fp32_precision(ver.dtype):
            outs = model(feats, w2p, shift)
        occ = decode_occupancy(outs["occupancy_preds"],
                               loss_type=ver.occ_loss_type)
        return outs["bev_embed"], occ.to(torch.int32)
    return forward


def serve(args, times: Optional[List[Dict]] = None) -> int:
    """Serve until ``in/STOP`` (or ``--max-requests``); returns the count
    served.  ``times``, where given, gets one dict per claim that held a
    servable request: host seconds of ``"claim"``, ``"load"`` (load and
    validate), ``"upload"``, ``"copy"`` (the results to the host) and
    ``"write"`` (the npz responses); ``"forward"``, the forward's device
    seconds (CUDA events on the card, host seconds on the CPU);
    ``"batches"``, its forward calls, and ``"requests"``, its responses."""
    from .config.api import apply_cfg_options, build_ver_config, load_config
    from .convert.voxelformer import load_checkpoint
    from .models.detector import build_model
    from .runtime import resolve_device, set_fp32_precision
    from .utils.checkpoint import model_file
    from .ver_writer import volumes_from_bev

    device = resolve_device(args.device)
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    ver = build_ver_config(cfg)
    set_fp32_precision(ver.dtype)
    model = build_model(ver, device, seed=0)
    if args.checkpoint:
        load_checkpoint(model, model_file(args.checkpoint))

    inbox = os.path.join(args.queue, "in")
    outbox = os.path.join(args.queue, "out")
    claimed = os.path.join(args.queue,
                           f".claimed.{_claim_host()}-{os.getpid()}")
    for d in (inbox, outbox, claimed):
        os.makedirs(d, exist_ok=True)

    B = args.batch_max
    image_size = ver.feat_h * args.vit_patch_size
    forwards = {"features": make_forward(model, ver,
                                         occupancy=args.occupancy)}
    if args.images:
        from .convert.vit import load_hf_vit_state_dict
        from .models.vit import vit_for_ver
        vit = vit_for_ver(ver, patch_size=args.vit_patch_size,
                          num_layers=args.vit_layers,
                          num_heads=args.vit_heads, dtype=ver.dtype)
        if args.vit_checkpoint:
            sd = torch.load(args.vit_checkpoint, map_location="cpu")
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
            load_hf_vit_state_dict(vit, sd, prefix=args.hf_prefix)
        else:
            print("serve: no --vit-checkpoint: RANDOM ViT weights (smoke "
                  "only)", flush=True)
            vit.init_weights(torch.Generator().manual_seed(1))
        forwards["images"] = make_forward(model, ver, vit.to(device).eval(),
                                          occupancy=args.occupancy)

    def upload(rows):
        return torch.from_numpy(np.stack(rows)).to(device)

    served = 0
    print(f"serve: queue={args.queue} batch_max={B} "
          f"occupancy={args.occupancy} device={device}", flush=True)
    _sweep_orphans(args.queue, inbox)
    last_sweep = time.time()
    while True:
        if os.path.exists(os.path.join(inbox, "STOP")):
            os.remove(os.path.join(inbox, "STOP"))
            break
        if time.time() - last_sweep > 60.0:
            _sweep_orphans(args.queue, inbox)
            last_sweep = time.time()
        t0 = time.perf_counter()
        reqs = _claim(inbox, claimed, B)
        if not reqs:
            if args.max_requests is not None and served >= args.max_requests:
                break
            time.sleep(args.poll_ms / 1000.0)
            continue
        claimed_at = time.perf_counter()
        rec = dict(claim=claimed_at - t0, upload=0.0, forward=0.0, copy=0.0,
                   batches=0)

        # two homogeneous micro-batches, features and images
        groups = {k: [] for k in forwards}
        for path in reqs:
            try:
                kind, x, w, s = _load_request(path, ver, image_size,
                                              args.images)
            except Exception as e:  # noqa: BLE001 - any bad file
                _reject(path, inbox, outbox, e)
                continue
            groups[kind].append((path, x, w, s))
        rec["load"] = time.perf_counter() - claimed_at
        ok = [r[0] for g in groups.values() for r in g]
        if not ok:
            continue

        # freshen the claims after the validation (a malformed request
        # must keep the client's mtime, or the fresh-write check above
        # would bounce it forever), then keep them fresh while it runs
        keepalive = _ClaimKeepAlive(ok, interval_s=60.0)
        keepalive.start()
        results = []   # (path, volume, occupancy or None)
        try:
            for kind, rows in groups.items():
                if not rows:
                    continue
                n = len(rows)
                rows = rows + [rows[-1]] * (B - n)   # pad to the one shape
                t2 = time.perf_counter()
                args_dev = [upload([r[i] for r in rows]) for i in (1, 2, 3)]
                t3 = time.perf_counter()
                rec["upload"] += t3 - t2
                if device.type == "cuda":
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                bev, occ = forwards[kind](*args_dev)
                if device.type == "cuda":
                    ev[1].record()
                t4 = time.perf_counter()
                vol = volumes_from_bev(bev[:n].float().cpu().numpy(), ver)
                occ = None if occ is None else occ[:n].cpu().numpy()
                t5 = time.perf_counter()
                rec["copy"] += t5 - t4
                rec["forward"] += (ev[0].elapsed_time(ev[1]) / 1e3
                                   if device.type == "cuda" else t4 - t3)
                rec["batches"] += 1
                results += [(r[0], vol[i], None if occ is None else occ[i])
                            for i, r in enumerate(rows[:n])]
        finally:
            keepalive.stop()
        t6 = time.perf_counter()
        for path, vol_i, occ_i in results:
            rid = os.path.basename(path)[:-4]
            out = {"volume": vol_i}
            if occ_i is not None:
                out["occupancy"] = occ_i.astype(np.int32)
            tmp = os.path.join(outbox, f".{rid}.tmp.npz")
            np.savez(tmp, **out)
            os.replace(tmp, os.path.join(outbox, f"{rid}.npz"))
            try:
                os.remove(path)
            except OSError:
                pass  # a peer's sweep took it; the response stands
        rec.update(write=time.perf_counter() - t6, requests=len(results))
        if times is not None:
            times.append(rec)
        served += len(results)
        if args.max_requests is not None and served >= args.max_requests:
            break
    print(f"serve: done, served {served}", flush=True)
    return served


def main(argv=None) -> int:
    return serve(parse_args(argv))


if __name__ == "__main__":
    main()
