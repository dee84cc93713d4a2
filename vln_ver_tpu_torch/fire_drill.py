"""The day-one fire drill through the port (PyTorch port of
``tools/fire_drill.py``).

The quality bars (occupancy mIoU, R2R SR/SPL) need licensed MP3D / R2R
data.  This wires the day-one path into one command, so that given real
data nothing needs thought:

  1. contract    -- the dataset loads; shapes, dtypes, the flat order
  2. capacity    -- the sparse lift's capacity against the rig
                    (``check_query_capacity``)
  3. convert     -- a reference ``.pth`` loads strictly into the model
                    (``convert.load_checkpoint``); without one, in a dry
                    run, a random model's weights round-trip through a
                    ``.pth`` to the same forward
  4. eval        -- ``test`` (occupancy mIoU, indoor mAP)
  5. dump        -- ``get_occ`` (the product path)
  5b. images     -- ``get_occ --from-images`` (the fused ViT path)
  5c. mesh_dump  -- the dump on a process grid of one data group and two
                    view ranks (torchrun), against stage 5's volumes
  6. vln         -- ``train_vln`` imitation steps

Usage (real data):
  python -m vln_ver_tpu_torch.fire_drill configs/verformer/vocc.py \
      --torch-ckpt /path/vocc.pth \
      --r2r-data-dir /path/R2R --connectivity /path/connectivity

Dry run on synthetic data, on the CPU:
  python -m vln_ver_tpu_torch.fire_drill configs/verformer/vocc_tiny.py \
      --synthetic --device cpu

Stages 1 and 3 run in this process, the others as subprocesses of the
port's CLIs, each with ``--device`` passed on.  The mesh stage needs two
ranks: gloo processes on the CPU, or two cards.  The drill stops at the
first failure and prints a PASS/FAIL summary either way.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("contract", "capacity", "convert", "eval", "dump", "images",
          "mesh_dump", "vln")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.fire_drill", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="mmcv-style vocc config")
    p.add_argument("--synthetic", action="store_true",
                   help="generate synthetic data where files are absent "
                        "(dry-run mode)")
    p.add_argument("--torch-ckpt", default=None,
                   help="reference .pth; stage 3 loads it and eval / dump "
                        "use it")
    p.add_argument("--checkpoint", default=None,
                   help="weights for eval / dump (overrides --torch-ckpt)")
    p.add_argument("--limit", type=int, default=4,
                   help="samples per eval/dump/capacity stage")
    p.add_argument("--vln-steps", type=int, default=24,
                   help="imitation smoke steps (stage 6)")
    p.add_argument("--r2r-data-dir", default=None,
                   help="R2R episode JSONs (forwarded to train_vln)")
    p.add_argument("--connectivity", default=None,
                   help="MP3D connectivity graphs (forwarded to train_vln)")
    p.add_argument("--work-dir", default="work_dirs/fire_drill")
    p.add_argument("--vit-checkpoint", default=None,
                   help="HF ViT state dict for the image stage (random "
                        "weights otherwise: smoke only)")
    p.add_argument("--skip", nargs="*", default=[], metavar="STAGE",
                   help=f"stage names to skip ({' '.join(STAGES)})")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p.parse_args(argv)


def _env():
    """This process's environment without a process group's variables, so
    a stage never joins a group it was not launched into."""
    return {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                         "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}


def _run(cmd, log_path):
    """Run a stage's command from the repository root; (ok, log tail)."""
    with open(log_path, "w") as log:
        r = subprocess.run([sys.executable] + cmd, cwd=REPO, env=_env(),
                           stdout=log, stderr=subprocess.STDOUT)
    with open(log_path) as f:
        tail = "".join(f.readlines()[-12:])
    return r.returncode == 0, tail


def _count_volumes(path):
    import h5py
    with h5py.File(path, "r") as f:
        return len(f)


def stage_contract(args, ver, cfg) -> str:
    """The dataset loads and keeps the byte contract."""
    import numpy as np

    from .config.api import dataset_kwargs
    from .data.mp3d import MP3DDataset
    from .data.synthetic import make_synthetic_dataset

    ds_kw = dataset_kwargs(cfg, "val") or dataset_kwargs(cfg, "train")
    ann, root = ds_kw["ann_file"], ds_kw["data_root"]
    if not os.path.exists(ann):
        if not args.synthetic:
            raise FileNotFoundError(
                f"{ann}: pass real data paths in the config, or "
                "--synthetic for a dry run")
        os.makedirs(root or "data/mp3d", exist_ok=True)
        ann = make_synthetic_dataset(
            root or "data/mp3d", num_cams=ver.num_cams,
            feat_hw=ver.feat_h, feat_dim=ver.in_channels,
            occ_dims=(ver.occ_zdim, ver.occ_ydim, ver.occ_xdim),
            pc_range=ver.pc_range)
    ds = MP3DDataset(ann, root, voxel_num=ver.voxel_num,
                     occupancy_classes=ver.occupancy_classes,
                     num_cams=ver.num_cams, feat_hw=ver.feat_h)
    try:
        assert len(ds) > 0, "empty dataset"
        for idx in {0, len(ds) - 1}:
            s = ds[idx]
            f = s["features"]
            assert f.shape == (ver.num_cams, ver.feat_h, ver.feat_w,
                               ver.in_channels), f.shape
            assert f.dtype == np.float32, f.dtype
            assert np.isfinite(f).all(), "non-finite features"
            w = s["world2pixel"]
            assert w.shape == (ver.num_cams, 4, 4) and np.isfinite(w).all()
            assert s["origin_shift"].shape == (3,)
            if "occ_dense" in s:
                occ = s["occ_dense"]
                # flat order z*(Y*X) + y*X + x; labels in [0, C], C = empty
                assert occ.shape == (ver.voxel_num,), occ.shape
                assert occ.min() >= 0 and occ.max() <= ver.occupancy_classes
        return f"{len(ds)} samples, contract ok"
    finally:
        ds.close()


def stage_convert(args, ver, device) -> str:
    """A reference ``.pth`` loads strictly; in a dry run without one, a
    seed-0 model's weights written as a reference ``.pth`` and loaded into
    a seed-1 model give the seed-0 forward exactly."""
    import torch

    from .bench import example_inputs
    from .convert.voxelformer import load_checkpoint
    from .models import build_model

    if args.torch_ckpt:
        skipped = load_checkpoint(build_model(ver, device, seed=0),
                                  args.torch_ckpt)
        return (f"{args.torch_ckpt} loads strictly ({len(skipped)} dead "
                "reference keys skipped)")
    src = build_model(ver, device, seed=0)
    path = os.path.join(args.work_dir, "selftest_ref.pth")
    torch.save(src.state_dict(), path)
    dst = build_model(ver, device, seed=1)
    load_checkpoint(dst, path)
    ins = [torch.from_numpy(a).to(device)
           for a in example_inputs(ver, batch=1)]
    with torch.inference_mode():
        a = src(*ins, only_bev=True)["bev_embed"]
        b = dst(*ins, only_bev=True)["bev_embed"]
    if not torch.equal(a, b):
        raise AssertionError("the round-tripped weights give another "
                             "forward")
    return f"selftest: {len(src.state_dict())} tensors round-trip exactly"


def main(argv=None) -> None:
    args = parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    import torch

    from .config.api import build_ver_config, dataset_kwargs, load_config
    from .runtime import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    ver = build_ver_config(cfg)
    syn = ["--synthetic"] if args.synthetic else []
    dev = ["--device", args.device]
    ckpt = args.checkpoint
    results = []

    def finish():
        print("\n=== fire drill summary ===")
        for name, ok, _ in results:
            print(f"  {'PASS' if ok else 'FAIL'}  {name}")
        bad = [n for n, ok, _ in results if not ok]
        if bad:
            print(f"\nfailed at: {bad[0]} (log under {args.work_dir})")
            sys.exit(1)
        print("\nall stages green: the day-one path works on this data")
        sys.exit(0)

    mark = [time.time()]

    def record(name, ok, detail):
        results.append((name, ok, detail))
        last = detail.strip().splitlines()[-1] if detail.strip() else ""
        now = time.time()
        print(f"[fire_drill] {name}: {'PASS' if ok else 'FAIL'} "
              f"({now - mark[0]:.1f}s) - {last}", flush=True)
        mark[0] = now
        if not ok:
            finish()

    def in_process(name, fn, *a):
        try:
            record(name, True, fn(*a))
        except Exception as e:  # noqa: BLE001 - report, don't crash
            record(name, False, f"{type(e).__name__}: {e}")

    t0 = time.time()
    if "contract" not in args.skip:
        in_process("contract", stage_contract, args, ver, cfg)

    if "capacity" not in args.skip:
        cmd = ["-m", "vln_ver_tpu_torch.check_query_capacity", args.config,
               "--limit", str(args.limit), "--split", "val"] + syn
        if ver.sca_query_capacity:
            cmd += ["--capacity", str(ver.sca_query_capacity)]
        record("capacity", *_run(cmd, f"{args.work_dir}/capacity.log"))

    if "convert" not in args.skip and (args.torch_ckpt or args.synthetic):
        in_process("convert", stage_convert, args, ver, device)
        if args.torch_ckpt and not ckpt:
            ckpt = args.torch_ckpt
    with_ckpt = ["--checkpoint", ckpt] if ckpt else []

    if "eval" not in args.skip:
        cmd = (["-m", "vln_ver_tpu_torch.test", args.config, "--limit",
                str(args.limit)] + syn + with_ckpt + dev)
        record("eval", *_run(cmd, f"{args.work_dir}/eval.log"))

    ver_h5 = os.path.join(args.work_dir, "ver.hdf5")
    if "dump" not in args.skip:
        if os.path.exists(ver_h5):
            os.remove(ver_h5)
        cmd = (["-m", "vln_ver_tpu_torch.get_occ", args.config, "--limit",
                str(args.limit), "--out", ver_h5] + syn + with_ckpt + dev)
        ok, tail = _run(cmd, f"{args.work_dir}/dump.log")
        if ok:
            n = _count_volumes(ver_h5)
            ok, tail = n > 0, f"{tail}\n{n} volumes in {ver_h5}"
        record("dump", ok, tail)

    if "images" not in args.skip:
        ds_kw = dataset_kwargs(cfg, "test") or dataset_kwargs(cfg, "val")
        have_imgs = args.synthetic or (ds_kw and os.path.exists(
            os.path.join(REPO, ds_kw["data_root"] or "",
                         "panorama_images.hdf5")))
        if not have_imgs:
            print("[fire_drill] images: skipped (no panorama_images.hdf5 "
                  "under the data root)", flush=True)
        else:
            img_h5 = os.path.join(args.work_dir, "ver_from_images.hdf5")
            if os.path.exists(img_h5):
                os.remove(img_h5)
            cmd = ["-m", "vln_ver_tpu_torch.get_occ", args.config,
                   "--from-images", "--limit", str(args.limit), "--out",
                   img_h5] + syn
            if args.synthetic:
                # a ViT whose heads divide a tiny config's channels
                cmd += ["--vit-layers", "2", "--vit-heads", "4"]
            if args.vit_checkpoint:
                cmd += ["--vit-checkpoint", args.vit_checkpoint]
            ok, tail = _run(cmd + with_ckpt + dev,
                            f"{args.work_dir}/images.log")
            if ok:
                n = _count_volumes(img_h5)
                ok, tail = n > 0, f"{tail}\n{n} fused volumes in {img_h5}"
            record("images", ok, tail)

    # two ranks: gloo processes on the CPU, one card each on CUDA
    two_ranks = device.type == "cpu" or torch.cuda.device_count() >= 2
    if ("mesh_dump" not in args.skip and "dump" not in args.skip
            and two_ranks):
        mesh_h5 = os.path.join(args.work_dir, "ver_mesh.hdf5")
        shard = mesh_h5 + ".shard0"
        if os.path.exists(shard):
            os.remove(shard)
        cmd = (["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m", "vln_ver_tpu_torch.get_occ",
                args.config, "--limit", str(args.limit), "--out", mesh_h5,
                "--mesh", "1,2", "--batch-size", "2"]
               + syn + with_ckpt + dev)
        ok, tail = _run(cmd, f"{args.work_dir}/mesh_dump.log")
        if ok:
            ok, err = _same_volumes(ver_h5, shard, 1e-3)
            tail += f"\nmesh-vs-plain max abs dev: {err:.2e}"
        record("mesh_dump", ok, tail)

    if "vln" not in args.skip:
        cmd = ["-m", "vln_ver_tpu_torch.train_vln", "--steps",
               str(args.vln_steps), "--eval-interval", str(args.vln_steps),
               "--eval-limit", "2", "--work-dir",
               os.path.join(args.work_dir, "vln")] + dev
        if args.r2r_data_dir:
            cmd += ["--data-dir", args.r2r_data_dir]
            if args.connectivity:
                cmd += ["--connectivity", args.connectivity]
            if os.path.exists(ver_h5):
                cmd += ["--ver", ver_h5]
        else:
            cmd += ["--synthetic"]
        record("vln", *_run(cmd, f"{args.work_dir}/vln.log"))

    print(f"\ntotal: {time.time() - t0:.1f}s")
    finish()


def _same_volumes(a_path, b_path, atol):
    """(same keys and every volume within ``atol``, the largest
    deviation)."""
    import h5py
    import numpy as np
    with h5py.File(a_path, "r") as fa, h5py.File(b_path, "r") as fb:
        if sorted(fa) != sorted(fb):
            return False, float("inf")
        err = max((float(np.abs(fa[k][:] - fb[k][:]).max()) for k in fa),
                  default=0.0)
    return err < atol, err


if __name__ == "__main__":
    main()
