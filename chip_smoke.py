#!/usr/bin/env python3
"""Drive the PyTorch port's VER volume path, its full forward and eval path
and its training path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, nothing is caught):
  1. require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from vln_ver_tpu_torch/csrc, time the build and
     print ptxas's registers and spills for every instantiation;
  3. hold the deformable-attention kernel, and its backward kernel
     (dvalue, dlocations, dweights), against the plain PyTorch version and
     its autograd at the full main-path shape (fp32 and bf16), at the eval
     path's (batch 2, phase 6) and at the edges of the launch plans: a
     10x20 map, bs=1, nq=57 and 901, B=8, one V stage (d=256), rows the
     TMA unit cannot take (d=3), far-out locations;
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
     shared-memory floor; then the same for the backward kernel against the
     plain version's autograd backward, with its own shared-memory floor
     and plan, and its dvalue and dlocations / dweights halves alone;
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
     the device's busy share and its largest kernels;
  7. train as ``python -m vln_ver_tpu_torch.train`` does
     (configs/verformer/vocc.py at full width, the same random weights
     from seed 0, phase 6's viewpoints with ground truth, batch
     samples_per_gpu = 1, the auction matcher): 2 warm-up steps, then 6
     timed steps through ``make_train_step``.  Each step must launch the
     forward and the backward kernel 3 times each, give every loss finite
     with the full key set and a finite gradient norm, and move the
     parameters; one step on the card must match a CPU step of the same
     weights and batch (0.2 m grid, dropout off, host matcher): the same
     matched queries, the losses and every parameter's gradient.  Print
     train steps/s, peak device memory, the device time of the forward,
     losses and matching, backward and optimizer (CUDA events), the busy
     share and largest kernels of one profiled step, then the ``kernels``
     line.
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
# phase 7: train steps at batch samples_per_gpu over phase 6's viewpoints
TRAIN_WARMUP, TRAIN_STEPS = 2, 6


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


def deform_bwd_bound(value, loc, weights, spatial_hw):
    """The same for the backward: value, locations, weights and the output
    gradient read once, dvalue, dlocations and dweights written once, vs
    two fp32 multiply-adds per channel for each tap inside the map (one
    into dvalue, one for the tap's dot product with the output gradient,
    from which dweights and dlocations follow)."""
    bs, hw, heads, d = value.shape
    nq = loc.shape[1]
    elt = value.element_size()
    nbytes = (2 * value.numel() * elt + 2 * loc.numel() * 4
              + 2 * weights.numel() * 4 + bs * nq * heads * d * elt)
    flops = valid_taps(loc, spatial_hw) * d * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def plain_grads(value, loc, weights, grad_out, spatial_hw):
    """(dvalue, dlocations, dweights) of the plain version by autograd, in
    fp32."""
    import torch

    from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d
    ins = [t.detach().float().requires_grad_()
           for t in (value, loc, weights)]
    out = ms_deform_attn_2d(ins[0], (spatial_hw,), ins[1], ins[2])
    return torch.autograd.grad(out, ins, grad_out.float())


def grad_out_like(bs, nq, heads, d, dtype, seed, device):
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (bs, nq, heads * d)).astype(np.float32)).to(device, dtype)


def smem_floor_ms(value, loc, spatial_hw, backward=False):
    """Least time for a gather from shared memory: each tap inside the map
    reads its row's d values once, at the card's shared-memory rate.  The
    backward's floor adds, for each such tap, one fp32 add per channel
    into dvalue's accumulator in shared memory (a read and a write, 8
    bytes): d x (elt + 8) bytes a tap."""
    d = value.shape[-1]
    per_value = value.element_size() + (8 if backward else 0)
    return (valid_taps(loc, spatial_hw) * d * per_value
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


def full_forward_and_eval(model, ver, card):
    """Phase 6; returns the kernel's launches over the eval run and the
    synthetic viewpoints."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.data import synthetic_samples
    from vln_ver_tpu_torch.evaluation.runner import (decode_outputs,
                                                     evaluate_model,
                                                     occupancy_hists)
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.occupancy import decode_occupancy
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD

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
    KERNEL.launches = KERNEL_BWD.launches = 0
    t0 = time.perf_counter()
    metrics = run_eval(samples)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches, bwd_launches = KERNEL.launches, KERNEL_BWD.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = -(-n // EVAL_BATCH)
    if launches != ver.encoder_layers * n_batches:
        fail(f"deform_attn_2d launched {launches} times in the eval run, "
             f"expected {ver.encoder_layers} x {n_batches} batches")
    if bwd_launches:
        fail(f"the eval run launched deform_attn_2d's backward "
             f"{bwd_launches} times, expected none")
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
        return launches, bwd_launches, samples
    print(f"device busy share of the eval path: "
          f"{100 * dev_us / 1e6 / wall:.1f}% of {1e3 * wall:.3f} ms wall "
          f"({2 * EVAL_BATCH} viewpoints, profiled run) [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")
    return launches, bwd_launches, samples


def training(ver, samples, card):
    """Phase 7; returns the forward and backward kernel launches over the
    timed train steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vln_ver_tpu_torch.config import build_train_config, load_config
    from vln_ver_tpu_torch.data import synthetic_samples
    from vln_ver_tpu_torch.data.mp3d import collate
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.runtime import fp32_precision
    from vln_ver_tpu_torch.train import (create_train_state, make_train_step,
                                         staged_batches, to_device)
    from vln_ver_tpu_torch.train.objective import detection_matches
    from vln_ver_tpu_torch.utils.params import grads_by_name, relu_masks

    dev = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs/verformer/vocc.py"))
    batch = int(cfg["data"]["samples_per_gpu"])
    tc = build_train_config(cfg, len(samples) // batch)
    model = build_model(ver, dev, seed=0)
    state = create_train_state(model, tc)
    step_fn = make_train_step(ver, tc)
    batches = [collate(samples[i:i + batch])
               for i in range(0, len(samples) - batch + 1, batch)]
    need = TRAIN_WARMUP + TRAIN_STEPS
    batches = (batches * -(-need // len(batches)))[:need]

    def run(host_batches):
        return [step_fn(state, b, seed=1) for b in staged_batches(
            host_batches, lambda b: to_device(b, dev))]

    run(batches[:TRAIN_WARMUP])   # warm-up: allocator, cuBLAS, cuDNN
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = KERNEL_BWD.launches = 0
    t0 = time.perf_counter()
    metrics = run(batches[TRAIN_WARMUP:])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = KERNEL.launches, KERNEL_BWD.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    want = ver.encoder_layers * TRAIN_STEPS
    if fwd != want or bwd != want:
        fail(f"the train steps launched deform_attn_2d {fwd} and its "
             f"backward {bwd} times, expected {ver.encoder_layers} each "
             f"x {TRAIN_STEPS} steps")
    keys = {"loss_cls", "loss_bbox", "loss_occupancy", "loss_flow", "loss",
            "grad_norm", "sca_overflow"}
    keys |= {f"d{i}.loss_{k}" for i in range(ver.decoder_layers - 1)
             for k in ("cls", "bbox")}
    if ver.predicts_layout:
        keys.add("loss_layout")
    host = [{k: float(v) for k, v in m.items()} for m in metrics]
    for m in host:
        if set(m) != keys:
            fail(f"train metrics {sorted(m)}, want {sorted(keys)}")
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad or m["sca_overflow"] != 0:
            fail(f"train step metrics not finite: {bad} (or overflow)")
    after = dict(model.named_parameters())
    stuck = [n for n, p in after.items() if torch.equal(before[n], p)
             and p.grad is not None and bool(p.grad.any())]
    moved = sum(not torch.equal(before[n], p) for n, p in after.items())
    if stuck or moved < 0.95 * len(after):
        fail(f"parameters did not move: {moved} of {len(after)} moved; "
             f"with a gradient but unmoved: {stuck[:5]}")
    print("train losses by step: " + json.dumps(
        [{k: m[k] for k in ("loss", "loss_cls", "loss_bbox",
                            "loss_occupancy", "grad_norm")} for m in host]))
    print(f"train: {TRAIN_STEPS} steps in {train_s:.4f}s = "
          f"{TRAIN_STEPS / train_s:.3f} steps/s, "
          f"{TRAIN_STEPS * batch / train_s:.3f} viewpoints/s at batch "
          f"{batch} ({tc.matcher} matcher), peak device memory "
          f"{peak_mib:.1f} MiB, {moved} of {len(after)} parameters moved, "
          f"deform launches {fwd} forward + {bwd} backward [{card}]")

    # the real step's stages, timed with CUDA events recorded by hooks on
    # the calls step_fn makes: the model's forward, the optimizer's
    # zero_grad (just before the backward) and apply_gradients
    ev = {}

    def mark(name):
        ev[name] = torch.cuda.Event(enable_timing=True)
        ev[name].record()

    def wrap(obj, attr, before, after=None):
        inner = getattr(obj, attr)

        def call(*a, **k):
            mark(before)
            out = inner(*a, **k)
            if after:
                mark(after)
            return out
        setattr(obj, attr, call)

    hooks = [model.register_forward_pre_hook(lambda *_: mark("start")),
             model.register_forward_hook(lambda *_: mark("forward"))]
    wrap(state.optimizer, "zero_grad", "losses")
    wrap(state, "apply_gradients", "backward", "update")

    def stage_step(b):
        step_fn(state, b, seed=1)
        torch.cuda.synchronize()
        names = ("start", "forward", "losses", "backward", "update")
        return [ev[names[i]].elapsed_time(ev[names[i + 1]])
                for i in range(4)]

    b = to_device(batches[0], dev)
    stage_step(b)
    spans = stage_step(b)
    for h in hooks:
        h.remove()
    del state.optimizer.zero_grad, state.apply_gradients
    print(f"train step device time at batch {batch} (elapsed between CUDA "
          f"events in step_fn): forward {spans[0]:.3f} ms, losses and "
          f"matching {spans[1]:.3f} ms, backward {spans[2]:.3f} ms, clip and "
          f"AdamW {spans[3]:.3f} ms, total {sum(spans):.3f} ms [{card}]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, b, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us:
        print(f"device busy share of a train step: "
              f"{100 * dev_us / 1e6 / wall:.1f}% of {1e3 * wall:.3f} ms wall "
              f"(profiled run) [{card}]")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<4d} {e.key[:90]}")
    else:
        print("train device busy share: not measured (the profiler "
              "recorded no device time)")

    # one step on the card against one on the CPU: the same weights and
    # batch, dropout off, the exact host matcher, on the 0.2 m grid (the
    # CPU's full-grid upsampler takes minutes)
    check = dataclasses.replace(ver, occupancy_size=(0.2, 0.2, 0.2),
                                dropout_rate=0.0)
    grid = (check.occ_zdim, check.occ_ydim, check.occ_xdim)
    one = collate(synthetic_samples(
        1, 1, num_cams=check.num_cams, feat_hw=check.feat_h,
        feat_dim=check.in_channels, occ_dims=grid, pc_range=check.pc_range,
        seed=7, split="train"))
    tc_host = dataclasses.replace(tc, matcher="host")
    # the card's ReLUs take the CPU step's masks (utils.params.relu_masks):
    # at a kink the gradient is not set by the forward values, and one
    # pre-activation within rounding of 0 in a class branch moved that
    # branch's weight gradient by 3.6 % between card and CPU
    masks, res = [], {}
    for device in (torch.device("cpu"), dev):
        t0 = time.perf_counter()
        m = build_model(check, device, seed=0)
        bb = to_device(one, device)
        with torch.no_grad(), fp32_precision(check.dtype):
            outs = m.train()(bb["features"], bb["world2pixel"],
                             bb["origin_shift"])
            matched = detection_matches(outs["all_cls_scores"],
                                        outs["all_bbox_preds"], bb, "host")
        st = create_train_state(m, tc_host)
        cpu = device.type == "cpu"
        with relu_masks(m, record=masks if cpu else None,
                        pin=None if cpu else masks) as flips:
            mets = make_train_step(check, tc_host)(st, bb, seed=1)
        res[device.type] = (matched.cpu(),
                            {k: float(v) for k, v in mets.items()},
                            {n: g.cpu() for n, g in grads_by_name(m).items()},
                            time.perf_counter() - t0, flips[0])
    (mc, lc, gc, _, flips), (mh, lh, gh, cpu_s, _) = res["cuda"], res["cpu"]
    print(f"train step card vs CPU: ReLU masks of the CPU step pinned on the "
          f"card, {flips} of {sum(int(x.numel()) for x in masks)} elements "
          f"where the card's own mask differs")
    if not torch.equal(mc, mh):
        fail(f"matched queries differ between card and CPU in "
             f"{int((mc != mh).sum())} of {mc.numel()} GT slots: a near-tie "
             f"in the matching cost flipped (card {mc.tolist()}, CPU "
             f"{mh.tolist()}); the tolerances below assume equal matches")
    worst_loss = max(abs(lc[k] - lh[k]) / max(abs(lh[k]), 1e-12)
                     for k in lh if k != "sca_overflow")
    bad = [k for k in lh if abs(lc[k] - lh[k]) > 1e-4 * abs(lh[k]) + 1e-7]
    print(f"train step card vs CPU (vocc.py widths, occupancy grid {grid}, "
          f"host matcher): matched queries equal ({mc.numel()} GT slots), "
          f"largest relative loss difference {worst_loss:.3e} (rtol 1e-4) "
          f"{'ok' if not bad else 'FAIL ' + str(bad)}; grad_norm card "
          f"{lc['grad_norm']:.6f}, CPU {lh['grad_norm']:.6f}")
    if bad:
        fail(f"card train losses disagree with the CPU step: {bad}")
    worst, failed = (0.0, None), []
    for n, g_cpu in gh.items():
        diff = float(torch.linalg.vector_norm((gc[n] - g_cpu).double()))
        ref = float(torch.linalg.vector_norm(g_cpu.double()))
        rel = diff / max(ref, 1e-30)
        if diff > 1e-3 * ref + 1e-5 * g_cpu.numel() ** 0.5:
            failed.append(n)
        if ref > 0 and rel > worst[0]:
            worst = (rel, n)
    print(f"train step gradients card vs CPU: {len(gh)} parameters, worst "
          f"relative L2 difference {worst[0]:.3e} ({worst[1]}) (within "
          f"1e-3 relative + 1e-5 x sqrt(n)) "
          f"{'ok' if not failed else 'FAIL ' + str(failed[:5])}; the CPU "
          f"step took {cpu_s:.2f}s")
    if failed:
        fail(f"card gradients disagree with the CPU step: {failed[:5]}")
    return fwd, bwd


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
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
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

    bwd_tolerance = {
        f32: {"dvalue": (1e-4, 1e-5), "dlocations": (1e-3, 1e-4),
              "dweights": (1e-4, 1e-5)},
        bf16: dict.fromkeys(("dvalue", "dlocations", "dweights"),
                            (1e-2, 1e-2))}
    bwd_main_errs = None
    for i, (name, bs, H, W, dd, nq, dt, rng_) in enumerate(checks):
        v, loc, w = deform_inputs(bs, H * W, heads, dd, nq, P, dt, i, dev,
                                  *rng_)
        g = grad_out_like(bs, nq, heads, dd, dt, 100 + i, dev)
        got = KERNEL_BWD(v, ((H, W),), loc, w, g)
        torch.cuda.synchronize()
        ref = plain_grads(v, loc, w, g, (H, W))
        torch.cuda.synchronize()
        errs, bad = {}, []
        for key, a, r in zip(("dvalue", "dlocations", "dweights"), got, ref):
            if a.dtype != (dt if key == "dvalue" else f32):
                fail(f"backward {key} is {a.dtype} ({name})")
            errs[key], ok = close(a.float(), r, *bwd_tolerance[dt][key])
            if not ok:
                bad.append(key)
        plan = KERNEL_BWD.last_plan
        print(f"backward kernel check {name}: " + ", ".join(
            f"{k} max_abs_err={e:.3e} (rtol={bwd_tolerance[dt][k][0]}, "
            f"atol={bwd_tolerance[dt][k][1]})" for k, e in errs.items())
            + f" {'FAIL ' + str(bad) if bad else 'ok'} [ctas {plan.ctas}: "
            f"{plan.value_ctas} value in clusters of {plan.qsplit}, "
            f"{plan.sum_ctas} sums of chunk {plan.chunk}]")
        if bad:
            fail(f"deform_attn_2d_backward disagrees with the plain "
                 f"version's autograd ({name}: {bad})")
        if bwd_main_errs is None:
            bwd_main_errs = errs

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
    KERNEL.launches = KERNEL_BWD.launches = 0
    t0 = time.perf_counter()
    vols, bevs = run_main_path()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, bwd_launches = KERNEL.launches, KERNEL_BWD.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = -(-N_VIEWPOINTS // BATCH)
    if launches != ver.encoder_layers * n_batches:
        fail(f"deform_attn_2d launched {launches} times on the main path, "
             f"expected {ver.encoder_layers} x {n_batches} batches")
    if bwd_launches:
        fail(f"the main path launched deform_attn_2d's backward "
             f"{bwd_launches} times, expected none")
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

    bwd_timing, bwd_plans = {}, {}
    for dt in (f32, bf16):
        for B in (1, 4):
            bs = B * ver.num_cams
            v, loc, w = deform_inputs(bs, H * W, heads, d, nq, P, dt,
                                      10 + B, dev)
            g = grad_out_like(bs, nq, heads, d, dt, 20 + B, dev)
            ms = time_graph_ms(lambda: KERNEL_BWD(v, ((H, W),), loc, w, g))
            eager_ms = time_ms(lambda: KERNEL_BWD(v, ((H, W),), loc, w, g))
            name = f"B={B} {str(dt).split('.')[-1]}"
            bwd_plans[name] = KERNEL_BWD.last_plan._asdict()
            bound_ms, bound_by = deform_bwd_bound(v, loc, w, (H, W))
            floor_ms = smem_floor_ms(v, loc, (H, W), backward=True)
            plain_ms = None
            if dt is f32:
                # the plain version's autograd backward alone: one forward
                # graph kept, its backward replayed
                ins = [t.detach().requires_grad_() for t in (v, loc, w)]
                out = ms_deform_attn_2d(ins[0], ((H, W),), ins[1], ins[2])
                plain_ms = time_ms(lambda: torch.autograd.grad(
                    out, ins, g, retain_graph=True), iters=20, warmup=3)
                del out, ins
            bwd_timing[name] = (ms, eager_ms, plain_ms, bound_ms, bound_by,
                                floor_ms)
            plain = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
            plan = KERNEL_BWD.last_plan
            print(f"deform_attn_2d_backward {name} (bs={bs}): kernel "
                  f"{ms:.4f} ms (graph; eager {eager_ms:.4f} ms){plain}, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{100 * bound_ms / ms:.1f}% of bound, shared-memory floor "
                  f"{floor_ms:.4f} ms ({100 * floor_ms / ms:.1f}%); plan: "
                  f"{plan.ctas} CTAs ({plan.value_ctas} value CTAs of "
                  f"{plan.slices} 32-channel slices a pair, "
                  f"{plan.sum_ctas} sums CTAs of {plan.chunk} queries), "
                  f"clusters of {plan.qsplit} value CTAs with {plan.walkers} "
                  f"dV copies each, {plan.smem_bytes} B of shared memory a "
                  f"CTA [{card}]")
            if name == "B=1 float32":
                # its two halves: the dvalue scatter alone, the dlocations
                # and dweights sums alone
                dv_ms = time_graph_ms(lambda: KERNEL_BWD(
                    v, ((H, W),), loc, w, g, need_locations=False,
                    need_weights=False))
                sums_ms = time_graph_ms(lambda: KERNEL_BWD(
                    v, ((H, W),), loc, w, g, need_value=False))
                print(f"deform_attn_2d_backward {name}: dvalue alone "
                      f"{dv_ms:.4f} ms, dlocations and dweights alone "
                      f"{sums_ms:.4f} ms (graph) [{card}]")
    print("deform_attn_2d_backward timed plans: " + json.dumps(bwd_plans))

    # -- phase 6: full forward and eval ------------------------------------
    launches_eval, bwd_launches_eval, samples = full_forward_and_eval(
        model, ver, card)
    del model

    # -- phase 7: training -------------------------------------------------
    launches_train, bwd_launches_train = training(ver, samples, card)

    ms, eager_ms, plain_ms, bound_ms, bound_by, floor_ms = timing[
        "B=1 float32"]
    ms4, eager_ms4, plain_ms4, bound_ms4, _, floor_ms4 = timing[
        "B=4 float32"]
    # "launches" in both entries is the count over the timed train steps
    # (phase 7, the training path); "launches_dump" and "launches_eval" are
    # the counts of phases 4 and 6, each read from that run alone
    print(json.dumps({"kernels": [{
        "name": "deform_attn_2d",
        "route": "cuda",
        "source": "vln_ver_tpu_torch/csrc/deform_attn_2d.cu",
        "replaces": "vln_ver_tpu/ops/pallas_deform.py:38",
        "launches": launches_train,
        "launches_dump": launches,
        "launches_eval": launches_eval,
        "launches_train": launches_train,
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
    }, {
        "name": "deform_attn_2d_backward",
        "route": "cuda",
        "source": "vln_ver_tpu_torch/csrc/deform_attn_2d_bwd.cu",
        "replaces": "vln_ver_tpu/ops/pallas_deform.py:237",
        "launches": bwd_launches_train,
        "launches_dump": bwd_launches,
        "launches_eval": bwd_launches_eval,
        "launches_train": bwd_launches_train,
        "max_abs_err": max(bwd_main_errs.values()),
        "max_abs_err_dvalue": bwd_main_errs["dvalue"],
        "max_abs_err_dlocations": bwd_main_errs["dlocations"],
        "max_abs_err_dweights": bwd_main_errs["dweights"],
        "ms": bwd_timing["B=1 float32"][0],
        "plain_ms": bwd_timing["B=1 float32"][2],
        "bound_ms": bwd_timing["B=1 float32"][3],
        "bound_by": bwd_timing["B=1 float32"][4],
        "library_ms": None,
        "bound_share": (bwd_timing["B=1 float32"][3]
                        / bwd_timing["B=1 float32"][0]),
        "eager_ms": bwd_timing["B=1 float32"][1],
        "ms_b4": bwd_timing["B=4 float32"][0],
        "eager_ms_b4": bwd_timing["B=4 float32"][1],
        "plain_ms_b4": bwd_timing["B=4 float32"][2],
        "bound_ms_b4": bwd_timing["B=4 float32"][3],
        "smem_floor_ms": bwd_timing["B=1 float32"][5],
        "smem_floor_ms_b4": bwd_timing["B=4 float32"][5],
        "ms_bf16": bwd_timing["B=1 bfloat16"][0],
        "ms_bf16_b4": bwd_timing["B=4 bfloat16"][0],
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
