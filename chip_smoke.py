#!/usr/bin/env python3
"""Drive the PyTorch port's VER volume path and its full forward and eval
path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, nothing is caught):
  1. require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from vln_ver_tpu_torch/csrc, time the build and
     print ptxas's registers and spills for every instantiation;
  3. hold the deformable-attention kernel against its plain PyTorch version
     at the full main-path shape (fp32 and bf16), at the eval path's
     (batch 2, phase 6) and at the edges of its launch plan: a 10x20 map, bs=1, nq=57 and 901, B=8, one V stage
     (d=256), rows the TMA unit cannot take (d=3), far-out locations;
  4. run the main path as get_occ does (configs/verformer/get_occ.py, random
     weights from seed 0, 16 synthetic viewpoints, batch 4): the lift, the
     host copy and the dump layout (the HDF5 write needs h5py, which a
     PyTorch-only GPU host may lack; the CPU tests hold it against the JAX
     dump).  The kernel's launch count must be 3 per batch, every volume
     finite and (768, 4, 15, 15), and one batch's bev_embed must match a
     CPU run of the plain version;
  5. time the kernel (CUDA events over a CUDA graph of launches, so the
     wrapper's host time is left out; and over eager launches, as a caller
     sees it) and its plain version at batch 1 and batch 4 of the main
     path's shapes, print each timed launch's plan, the bytes bound and the
     shared-memory floor;
  6. run the full forward and the eval path as ``python -m
     vln_ver_tpu_torch.test`` does (configs/verformer/vocc.py at full
     width, the same random weights from seed 0, 8 synthetic viewpoints
     with ground truth at the full 35 x 120 x 120 occupancy grid, built in
     memory, batch 2): the kernel's launch count must be 3 per batch,
     every metric finite and in range, the head outputs of the right
     shapes, and one eval batch's outputs must match a CPU run of the same
     weights (vocc.py widths on the 0.2 m occupancy grid: the CPU takes
     minutes for the full grid).  Print viewpoints/s, peak device memory, the
     device time of each stage (CUDA events around the stage's modules),
     the device's busy share and its largest kernels, then the
     ``kernels`` line.
The last line is the ``{"ok": true, "device": ...}`` JSON object.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# shared memory: 128 B per clock per SM, 132 SMs, 1.98 GHz boost clock
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9

N_VIEWPOINTS = 16
BATCH = 4
# phase 6: synthetic viewpoints with ground truth, eval batch
EVAL_SCANS, EVAL_VPS_PER_SCAN, EVAL_BATCH = 2, 4, 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def close(got, ref, rtol, atol):
    """(max |got - ref|, all within atol + rtol*|ref|)."""
    import torch
    diff = (got.double() - ref.double()).abs()
    ok = bool(torch.all(diff <= atol + rtol * ref.double().abs()))
    return float(diff.max()), ok


def deform_inputs(bs, hw, heads, d, nq, P, dtype, seed, device, lo=-0.1,
                  hi=1.1):
    import torch
    rng = np.random.default_rng(seed)
    value = torch.from_numpy(rng.standard_normal(
        (bs, hw, heads, d)).astype(np.float32)).to(device, dtype)
    loc = torch.from_numpy(rng.uniform(
        lo, hi, (bs, nq, heads, 1, P, 2)).astype(np.float32)).to(device)
    logits = torch.from_numpy(rng.standard_normal(
        (bs, nq, heads, 1, P)).astype(np.float32)).to(device)
    return value, loc, logits.softmax(-1).contiguous()


def valid_taps(loc, spatial_hw):
    """Bilinear taps of these locations that land inside the map."""
    import torch
    H, W = spatial_hw
    x = loc[..., 0] * W - 0.5
    y = loc[..., 1] * H - 0.5
    taps = 0
    for fx in (torch.floor(x), torch.floor(x) + 1):
        for fy in (torch.floor(y), torch.floor(y) + 1):
            taps += int(((fx >= 0) & (fx <= W - 1)
                         & (fy >= 0) & (fy <= H - 1)).sum())
    return taps


def deform_bound(value, loc, weights, spatial_hw):
    """Least time for the function on these inputs: the bytes it must
    move (each input read once, the output written once) over the HBM
    rate vs its fp32 operations (a multiply-add per channel for each tap
    that lands inside the map, counted on this data) over the fp32 rate."""
    bs, hw, heads, d = value.shape
    nq = loc.shape[1]
    nbytes = (value.numel() * value.element_size() + loc.numel() * 4
              + weights.numel() * 4 + bs * nq * heads * d
              * value.element_size())
    flops = valid_taps(loc, spatial_hw) * d * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def smem_floor_ms(value, loc, spatial_hw):
    """Least time for a gather from shared memory: each tap inside the map
    reads its row's d values once, at the card's shared-memory rate."""
    d = value.shape[-1]
    return (valid_taps(loc, spatial_hw) * d * value.element_size()
            / SMEM_BYTES_PER_S * 1e3)


def time_ms(fn, iters=200, warmup=20):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, launches=50, replays=20):
    """Device time per call of ``fn``: ``launches`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host time of the Python wrapper is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def breakdown(run_main_path, bev_only, feats, w2p, shift, ver, card):
    """Where the main path's time goes: each stage synchronised and timed
    on the host clock, then one unsynchronised run under torch.profiler
    for the device's busy share and its largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vln_ver_tpu_torch.ver_writer import volumes_from_bev

    dev = torch.device("cuda")
    stages = dict(upload=0.0, forward=0.0, fetch=0.0, layout=0.0)
    for b0 in range(0, N_VIEWPOINTS, BATCH):
        sl = slice(b0, b0 + BATCH)
        t0 = time.perf_counter()
        args = (torch.from_numpy(feats[sl]).to(dev),
                torch.from_numpy(w2p[sl]).to(dev),
                torch.from_numpy(shift[sl]).to(dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bev, _ = bev_only(*args)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = bev.float().cpu().numpy()
        t3 = time.perf_counter()
        volumes_from_bev(host, ver)
        t4 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k] += dt
    total = sum(stages.values())
    print("main path stages (synchronised, host clock, "
          f"{N_VIEWPOINTS} volumes): " + ", ".join(
              f"{k} {1e3 * v:.3f} ms ({100 * v / total:.1f}%)"
              for k, v in stages.items()) + f" [{card}]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_main_path()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    if not dev_us:
        print("device busy share: not measured (the profiler recorded no "
              "device time)")
        return
    print(f"device busy share of the main path: "
          f"{100 * dev_us / 1e6 / wall:.1f}% of {1e3 * wall:.3f} ms wall "
          f"(profiled run) [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")


def stage_times(stages, run):
    """Device ms of each named group of modules over one call of ``run``:
    a CUDA event recorded before and after every call of those modules,
    the spans summed per group."""
    import torch
    spans = {name: [] for name in stages}
    handles = []
    for name, modules in stages.items():
        def pre(mod, args, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name].append([ev, None])

        def post(mod, args, out, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name][-1][1] = ev

        for m in modules:
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    return {name: sum(a.elapsed_time(b) for a, b in evs)
            for name, evs in spans.items()}


def full_forward_and_eval(model, ver, card) -> int:
    """Phase 6; returns the kernel's launches over the eval run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.data import synthetic_samples
    from vln_ver_tpu_torch.evaluation.runner import (decode_outputs,
                                                     evaluate_model,
                                                     occupancy_hists)
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.occupancy import decode_occupancy
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL

    dev = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs/verformer/vocc.py"))
    vocc = build_ver_config(cfg)
    # get_occ.py differs from vocc.py only in its dump target, so the
    # phase-4 weights are the vocc.py model's
    if vocc != ver:
        fail("configs/verformer/vocc.py and get_occ.py build different "
             "models")
    classes = tuple(cfg["data"]["test"].get("classes", ()))
    occ_dims = (ver.occ_zdim, ver.occ_ydim, ver.occ_xdim)
    t0 = time.perf_counter()
    samples = synthetic_samples(
        EVAL_SCANS, EVAL_VPS_PER_SCAN, num_cams=ver.num_cams,
        feat_hw=ver.feat_h, feat_dim=ver.in_channels, occ_dims=occ_dims,
        pc_range=ver.pc_range)
    n = len(samples)
    print(f"eval data: {n} synthetic viewpoints, occupancy {occ_dims}, in "
          f"{time.perf_counter() - t0:.2f}s")

    def run_eval(subset):
        return evaluate_model(model, subset, occ_thresholds=(0.25,),
                              batch_size=EVAL_BATCH, classes=classes)

    run_eval(samples[:EVAL_BATCH])    # warm-up: allocator, cuBLAS, cuDNN
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    t0 = time.perf_counter()
    metrics = run_eval(samples)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = KERNEL.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = -(-n // EVAL_BATCH)
    if launches != ver.encoder_layers * n_batches:
        fail(f"deform_attn_2d launched {launches} times in the eval run, "
             f"expected {ver.encoder_layers} x {n_batches} batches")
    for k, v in metrics.items():
        if not np.isfinite(v):
            fail(f"eval metric {k} = {v}")
    for k in ("miou", "iou"):                       # percent
        if not 0.0 <= metrics[k] <= 100.0:
            fail(f"eval metric {k} = {metrics[k]} outside [0, 100]")
    for k in ("occ_precision", "occ_recall"):
        if not 0.0 <= metrics[k] <= 1.0:
            fail(f"eval metric {k} = {metrics[k]} outside [0, 1]")
    if not any(k.startswith("mAP_") for k in metrics):
        fail("the eval run computed no detection mAP")
    print("eval metrics: " + json.dumps(metrics, sort_keys=True))
    print(f"eval: {n} viewpoints in {eval_s:.4f}s = {n / eval_s:.3f} "
          f"viewpoints/s at batch {EVAL_BATCH} (features on the host -> "
          f"metrics), peak device memory {peak_mib:.1f} MiB, deform "
          f"launches {launches} [{card}]")

    def batch_inputs(sl, device):
        return [torch.from_numpy(np.stack([s[k] for s in samples[sl]]))
                .to(device) for k in ("features", "world2pixel",
                                      "origin_shift")]

    # the head outputs' shapes at full width
    with torch.inference_mode():
        outs = model(*batch_inputs(slice(0, EVAL_BATCH), dev))
        want = {"all_cls_scores": (ver.decoder_layers, EVAL_BATCH,
                                   ver.num_query, ver.num_classes),
                "all_bbox_preds": (ver.decoder_layers, EVAL_BATCH,
                                   ver.num_query, ver.code_size),
                "occupancy_preds": (EVAL_BATCH, ver.voxel_num,
                                    ver.occupancy_classes),
                "bev_embed": (EVAL_BATCH, ver.bev_num, ver.embed_dims)}
        for k, shape in want.items():
            if tuple(outs[k].shape) != shape:
                fail(f"{k} {tuple(outs[k].shape)}, want {shape}")
            if not bool(torch.isfinite(outs[k]).all()):
                fail(f"non-finite values in {k}")
    print("full forward shapes: " + ", ".join(
        f"{k} {tuple(outs[k].shape)}" for k in want))

    # The CPU's transposed convolution took 319 s for one viewpoint of the
    # full 35 x 120 x 120 grid on the card's host (8 cores), too long for
    # this script, so the card is held against the CPU at vocc.py widths
    # on the 0.2 m grid (18 x 60 x 60, two upsampler stages), at the eval
    # batch: the kernel's launches then have the eval path's shape.
    check = dataclasses.replace(ver, occupancy_size=(0.2, 0.2, 0.2))
    with torch.inference_mode():
        card1 = build_model(check, dev, seed=0)(
            *batch_inputs(slice(0, EVAL_BATCH), dev))
        torch.cuda.synchronize()
        cpu_model = build_model(check, "cpu", seed=0)
        t0 = time.perf_counter()
        cpu1 = cpu_model(*batch_inputs(slice(0, EVAL_BATCH), "cpu"))
        cpu_s = time.perf_counter() - t0
    grid = (check.occ_zdim, check.occ_ydim, check.occ_xdim)
    tolerance = {"bev_embed": (1e-4, 1e-4), "all_cls_scores": (1e-4, 1e-4),
                 "all_bbox_preds": (1e-4, 1e-4),
                 "occupancy_preds": (1e-4, 5e-4)}
    for k, (rtol, atol) in tolerance.items():
        err, ok = close(card1[k].cpu(), cpu1[k], rtol, atol)
        print(f"{k} card vs CPU ({EVAL_BATCH} viewpoints, vocc.py widths, "
              f"occupancy grid {grid}): max_abs_err={err:.3e} (rtol={rtol}, "
              f"atol={atol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"card {k} disagrees with the CPU run")
    same = (decode_occupancy(card1["occupancy_preds"].cpu(), 0.25)
            == decode_occupancy(cpu1["occupancy_preds"], 0.25))
    share = float(same.float().mean())
    print(f"decoded occupancy labels card vs CPU: {100 * share:.4f}% "
          f"equal (need >= 99.99%); the CPU forward took {cpu_s:.2f}s")
    if share < 0.9999:
        fail("decoded occupancy labels of card and CPU differ")

    # where the time goes: device time per stage at batch EVAL_BATCH
    head = model.pts_bbox_head
    inputs = batch_inputs(slice(0, EVAL_BATCH), dev)
    gt = torch.from_numpy(np.stack(
        [s["occ_dense"] for s in samples[:EVAL_BATCH]])).to(dev)
    weight = torch.from_numpy(np.stack(
        [s["occ_visible"] for s in samples[:EVAL_BATCH]])).to(dev)
    stages = {"encoder": [head.transformer.encoder],
              "decoder with branches": [head.transformer.decoder,
                                        *head.cls_branches],
              "upsampler": [head.up_sample],
              "occupancy projection and MLP": [head.occ_proj,
                                               head.occ_branches]}

    last = {}

    def one_batch():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.inference_mode():
            ev[0].record()
            o = model(*inputs)
            ev[1].record()
            decode_outputs(o, ver)
            occupancy_hists(o["occupancy_preds"], gt, weight, (0.25,), ver)
            ev[2].record()
        torch.cuda.synchronize()
        last["forward"] = ev[0].elapsed_time(ev[1])
        last["decode and histogram"] = ev[1].elapsed_time(ev[2])

    one_batch()
    times = stage_times(stages, one_batch)
    times["decode and histogram"] = last["decode and histogram"]
    print(f"device time per batch of {EVAL_BATCH} (CUDA events): forward "
          f"{last['forward']:.3f} ms; " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in times.items()) + f" [{card}]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_eval(samples[:2 * EVAL_BATCH])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    if not dev_us:
        print("eval device busy share: not measured (the profiler recorded "
              "no device time)")
        return launches
    print(f"device busy share of the eval path: "
          f"{100 * dev_us / 1e6 / wall:.1f}% of {1e3 * wall:.3f} ms wall "
          f"({2 * EVAL_BATCH} viewpoints, profiled run) [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "vln_ver_tpu_torch")):
        fail(f"no vln_ver_tpu_torch package beside {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, REPO)

    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.ops import build
    from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL
    from vln_ver_tpu_torch.runtime import set_fp32_precision
    from vln_ver_tpu_torch.ver_writer import volumes_from_bev

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- phase 2: build --------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f}s")
    spills = []
    for lib in libs.values():
        name = spill = None
        for line in lib.with_suffix(".so.log").read_text().splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                t = re.search(r"kernelI(f|13__nv_bfloat16)Li(\d+)E",
                              m.group(1))
                name = (f"{lib.stem.split('-')[0][3:]}<"
                        f"{'float' if t.group(1) == 'f' else 'bf16'}, "
                        f"KC={t.group(2)}>" if t else m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
                spills.append(spill)
            m = re.search(r"Used (\d+) registers", line)
            if m:
                print(f"  ptxas: {name}: {m.group(1)} registers, {spill} "
                      "bytes of spill")
    print(f"ptxas: {sum(spills)} bytes of spill stores and loads in all "
          f"{len(spills)} functions")

    # -- phase 3: kernel vs plain version --------------------------------
    heads, d, P = 8, 96, 8
    f32, bf16 = torch.float32, torch.bfloat16
    checks = [  # (name, bs, H, W, d, nq, dtype, loc range)
        ("main fp32 B=1", 6, 14, 14, 96, 900, f32, (-0.1, 1.1)),
        ("main bf16 B=1", 6, 14, 14, 96, 900, bf16, (-0.1, 1.1)),
        ("eval B=2 fp32", 6 * EVAL_BATCH, 14, 14, 96, 900, f32, (-0.1, 1.1)),
        ("10x20 nq=57 fp32", 4, 10, 20, 96, 57, f32, (-0.1, 1.1)),
        ("bs=1 fp32", 1, 14, 14, 96, 900, f32, (-0.1, 1.1)),
        ("nq=901 fp32", 6, 14, 14, 96, 901, f32, (-0.1, 1.1)),
        ("nq=901 bf16", 6, 14, 14, 96, 901, bf16, (-0.1, 1.1)),
        ("B=8 fp32", 48, 14, 14, 96, 900, f32, (-0.1, 1.1)),
        ("one stage d=256 fp32", 6, 14, 14, 256, 900, f32, (-0.1, 1.1)),
        ("unaligned rows d=3 fp32", 4, 14, 14, 3, 57, f32, (-0.1, 1.1)),
        ("unaligned rows d=3 bf16", 4, 14, 14, 3, 57, bf16, (-0.1, 1.1)),
        ("far-out +-30 fp32", 6, 14, 14, 96, 900, f32, (-30.0, 30.0)),
    ]
    tolerance = {f32: (1e-4, 1e-5), bf16: (1e-2, 1e-2)}
    main_err = None
    with torch.inference_mode():
        for i, (name, bs, H, W, dd, nq, dt, rng_) in enumerate(checks):
            rtol, atol = tolerance[dt]
            v, loc, w = deform_inputs(bs, H * W, heads, dd, nq, P, dt, i,
                                      dev, *rng_)
            got = KERNEL(v, ((H, W),), loc, w)
            torch.cuda.synchronize()
            ref = ms_deform_attn_2d(v.float(), ((H, W),), loc, w)
            torch.cuda.synchronize()
            err, ok = close(got.float(), ref, rtol, atol)
            plan = KERNEL.last_plan
            print(f"kernel check {name}: max_abs_err={err:.3e} "
                  f"(rtol={rtol}, atol={atol}) {'ok' if ok else 'FAIL'} "
                  f"[ctas {plan.ctas}, chunk {plan.chunk}, stages "
                  f"{plan.stages}]")
            if not ok:
                fail(f"deform_attn_2d disagrees with the plain version "
                     f"({name})")
            if main_err is None:
                main_err = err

    # -- phase 4: the main path ------------------------------------------
    ver = build_ver_config(load_config(
        os.path.join(REPO, "configs/verformer/get_occ.py")))
    set_fp32_precision(ver.dtype)
    model = build_model(ver, dev, seed=0)

    rng = np.random.default_rng(0)
    feats = rng.standard_normal(
        (N_VIEWPOINTS, ver.num_cams, ver.feat_h, ver.feat_w,
         ver.in_channels)).astype(np.float32)
    pos = (rng.uniform(-1.0, 1.0, (N_VIEWPOINTS, 3))
           * np.array([1, 1, 0.3])).astype(np.float32)
    w2p = np.stack([np.stack([
        make_pinhole_world2pixel(70.0, deg * 360.0 / ver.num_cams, p)
        for deg in range(ver.num_cams)]) for p in pos])
    shift = pos

    @torch.inference_mode()
    def bev_only(f, m, s):
        outs = model(f, m, s, only_bev=True)
        return outs["bev_embed"], outs["sca_overflow"]

    def run_main_path():
        vols, bevs = [], []
        for b0 in range(0, N_VIEWPOINTS, BATCH):
            sl = slice(b0, b0 + BATCH)
            bev, ovf = bev_only(torch.from_numpy(feats[sl]).to(dev),
                                torch.from_numpy(w2p[sl]).to(dev),
                                torch.from_numpy(shift[sl]).to(dev))
            if ovf:
                fail(f"sca_overflow={ovf}")
            host = bev.float().cpu().numpy()
            bevs.append(host)
            vols.append(volumes_from_bev(host, ver))
        return vols, bevs

    run_main_path()   # warm-up: allocator, cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    t0 = time.perf_counter()
    vols, bevs = run_main_path()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = KERNEL.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = -(-N_VIEWPOINTS // BATCH)
    if launches != ver.encoder_layers * n_batches:
        fail(f"deform_attn_2d launched {launches} times on the main path, "
             f"expected {ver.encoder_layers} x {n_batches} batches")
    shape = (ver.embed_dims, ver.bev_z, ver.bev_h, ver.bev_w)
    for vol in vols:
        if vol.shape[1:] != shape or vol.dtype != np.float32:
            fail(f"volume batch {vol.shape} {vol.dtype}, want (B,)+{shape}")
        if not np.isfinite(vol).all():
            fail("non-finite values in the VER volumes")
    print(f"main path: {N_VIEWPOINTS} volumes of {shape} in {main_s:.4f}s "
          f"= {N_VIEWPOINTS / main_s:.2f} volumes/s at batch {BATCH}, "
          f"peak device memory {peak_mib:.1f} MiB, deform launches "
          f"{launches} [{card}]")

    cpu_model = build_model(ver, "cpu", seed=0)
    with torch.inference_mode():
        bev_cpu = cpu_model(torch.from_numpy(feats[:BATCH]),
                            torch.from_numpy(w2p[:BATCH]),
                            torch.from_numpy(shift[:BATCH]),
                            only_bev=True)["bev_embed"]
    err, ok = close(torch.from_numpy(bevs[0]), bev_cpu, 1e-4, 1e-4)
    print(f"bev_embed card vs CPU plain path (batch {BATCH}): "
          f"max_abs_err={err:.3e} (rtol=1e-4, atol=1e-4) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("card bev_embed disagrees with the CPU run")
    breakdown(run_main_path, bev_only, feats, w2p, shift, ver, card)

    # -- phase 5: kernel timing ------------------------------------------
    H = W = ver.feat_h
    nq = ver.bev_num
    timing, plans = {}, {}
    with torch.inference_mode():
        for dt in (f32, bf16):
            for B in (1, 4):
                bs = B * ver.num_cams
                v, loc, w = deform_inputs(bs, H * W, heads, d, nq, P, dt,
                                          10 + B, dev)
                ms = time_graph_ms(lambda: KERNEL(v, ((H, W),), loc, w))
                eager_ms = time_ms(lambda: KERNEL(v, ((H, W),), loc, w))
                name = f"B={B} {str(dt).split('.')[-1]}"
                plans[name] = KERNEL.last_plan._asdict()
                bound_ms, bound_by = deform_bound(v, loc, w, (H, W))
                floor_ms = smem_floor_ms(v, loc, (H, W))
                plain_ms = None
                if dt is f32:
                    plain_ms = time_ms(
                        lambda: ms_deform_attn_2d(v, ((H, W),), loc, w),
                        iters=20, warmup=3)
                timing[name] = (ms, eager_ms, plain_ms, bound_ms, bound_by,
                                floor_ms)
                plain = ("" if plain_ms is None
                         else f", plain {plain_ms:.4f} ms")
                print(f"deform_attn_2d {name} (bs={bs}): kernel {ms:.4f} ms "
                      f"(graph; eager {eager_ms:.4f} ms){plain}, bound "
                      f"{bound_ms:.4f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.1f}% of bound, shared-memory "
                      f"floor {floor_ms:.4f} ms ({100 * floor_ms / ms:.1f}%)"
                      f" [{card}]")
    print("deform_attn_2d timed plans: " + json.dumps(plans))

    # -- phase 6: full forward and eval ------------------------------------
    launches_eval = full_forward_and_eval(model, ver, card)

    ms, eager_ms, plain_ms, bound_ms, bound_by, floor_ms = timing[
        "B=1 float32"]
    ms4, eager_ms4, plain_ms4, bound_ms4, _, floor_ms4 = timing[
        "B=4 float32"]
    print(json.dumps({"kernels": [{
        "name": "deform_attn_2d",
        "route": "cuda",
        "source": "vln_ver_tpu_torch/csrc/deform_attn_2d.cu",
        "replaces": "vln_ver_tpu/ops/pallas_deform.py:38",
        "launches": launches,
        "launches_eval": launches_eval,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bound_share": bound_ms / ms,
        "eager_ms": eager_ms,
        "smem_floor_ms": floor_ms,
        "ms_b4": ms4,
        "eager_ms_b4": eager_ms4,
        "plain_ms_b4": plain_ms4,
        "bound_ms_b4": bound_ms4,
        "smem_floor_ms_b4": floor_ms4,
        "ms_bf16": timing["B=1 bfloat16"][0],
        "ms_bf16_b4": timing["B=4 bfloat16"][0],
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
