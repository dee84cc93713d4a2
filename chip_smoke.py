#!/usr/bin/env python3
"""Drive the PyTorch port's VER volume path, its full forward and eval path,
its training path and the VLN agent's evaluation and training paths once on
one NVIDIA GPU.

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
  4b. the sparse lift (the same model and viewpoints with
     sca_query_capacity=256): max_visible_queries of the viewpoints within
     256, sca_overflow 0, 3 launches per batch at nq=256, the volumes those
     of 4 within 1e-5; volumes/s, and the kernel's graph time at nq=256
     against nq=900;
  4c. the int8 upload (ver_writer.quantize_int8 on the host, dequantised on
     the card): the volumes against a CPU int8 run within 1e-4; the
     largest deviation from 4's fp32 volumes, the upload bytes per volume;
  4d. the fused image path (uint8 views -> ViT-B/16 -> lift in one call,
     get_occ.make_bev_only; 16 synthetic viewpoints of six 224 x 224 views,
     random ViT weights from seed 1): one viewpoint's ViT features against
     the CPU within 1e-4, the volumes against a two-stage run on the card
     (ViT, then the feature path) within 1e-5; volumes/s, the ViT's device
     ms per batch, peak memory, upload bytes per volume;
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
     share and largest kernels of one profiled step.  Then one step with
     remat_encoder (the forward kernel replayed on autograd's thread)
     against one without, and one step with sca_query_capacity=256
     against the dense step (the backward kernel at nq=256), each on the
     card with the same weights and batch: the same matched queries, the
     losses and every gradient;
  8. the VLN agent's evaluation as ``python -m vln_ver_tpu_torch.test_vln``
     runs it, fed by VER volumes made on the card: the synthetic
     environment (3 scans x 9 nodes, 16 episodes, seed 0); one synthetic
     viewpoint per token through phase 4's VER path (get_occ.py width,
     seed-0 weights, batch 4, the last batch padded), which must launch
     the forward kernel 3 times a batch and the backward never, each
     dump-layout volume read back as load_ver_features reads it; the
     full-width policy (PolicyConfig(embed_dims=768, vocab_size=4000):
     8 heads, 4 text and 4 + 4 fusion layers, FFN 1536, 80 tokens, 32
     memory nodes) with weights from a numpy generator of seed 2; greedy
     evaluation one episode at a time and in lockstep batches of 8, every
     metric finite and in range, the batched per-episode metrics equal
     to the sequential ones and evaluate / evaluate_batched equal to
     their means; every policy call of the batch-8 rollouts
     replayed on the CPU with the same weights and inputs (logits and
     log-softmax over the unmasked actions and state_pred within rtol
     1e-4 / atol 1e-4, the -1e9 entries equal, the greedy action equal
     wherever the top-2 margin exceeds 1e-3; vln_ver_tpu_torch/agent/
     replay.py).  The rates are timed over the same graphs and volumes
     with 256 episodes (the first 16 those above), two interleaved passes
     at batch 1 and 8, each pass's metrics in range and the batched ones
     equal to the sequential ones: decision steps/s and episodes/s,
     decisions per episode beside the expert paths' edges and R2R's, the
     share of batch rows still running, device ms per policy call (CUDA
     events; first and later calls apart), host ms per call (env
     stepping, memory_arrays, upload, the call) and peak device memory.
     Then the busy share of one profiled batch-8 rollout, and one later
     policy step alone at batch 1 and 8, in a CUDA graph and eager,
     beside its bound (the weights and inputs it reads and the outputs it
     writes over the HBM rate, GEMM operations over the fp32 peak); then
     an ``agent`` JSON line;
  9. the VLN agent's training as ``python -m vln_ver_tpu_torch.pretrain_vln``
     and ``train_vln`` run it, at phase 8's full width on phase 8's
     environment and volumes (no new kernel launch): the offline teacher
     records of its 16 episodes; pretraining (VLNPretrainModel, the policy
     plus the MLM head, random weights from seed 3, batch 16, dropout on,
     clip 40 + AdamW lr 5e-5) and imitation with DAgger (phase 8's
     seed-2 policy, student actions in half the rollouts, lockstep
     rollouts of 8 episodes, updates of 8 decision steps, dropout off,
     lr 1e-4), each through the CLI's own update loop: first one update's
     losses and every gradient on the card against the CPU's (the same
     weights and batch, pretraining's masked tokens drawn once, dropout
     off, the card's ReLUs pinned to the CPU's masks; losses within rtol
     1e-4, each gradient and the global norm within 1e-4 in relative L2;
     agent/replay.py), then 2 warm-up and 8 timed updates, every loss
     finite and the parameters moved: updates/s, decision steps trained/s,
     ms per update of the rollout (host), stacking and upload, forward and
     loss, backward, clip and AdamW (CUDA events), peak device memory, the
     busy share of one profiled update, GFLOP an update; then the handoff:
     save_model, load_model into a new policy (the weights equal) and
     evaluate_batched at batch 8 over the 16 episodes, every metric finite
     and in range; an ``agent_train`` JSON line.  Then the ``kernels``
     line and the script's total time.
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
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# shared memory: 128 B per clock per SM, 132 SMs, 1.98 GHz boost clock
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9

N_VIEWPOINTS = 16
BATCH = 4
# phase 4b: the sparse lift's capacity (vln_ver_tpu/models/config.py:125)
SPARSE_K = 256
# phase 4d: ViT-B/16 (HF ViTConfig defaults) in front of the lift
VIT_PATCH, VIT_LAYERS, VIT_HEADS = 16, 12, 12
# phase 6: synthetic viewpoints with ground truth, eval batch
EVAL_SCANS, EVAL_VPS_PER_SCAN, EVAL_BATCH = 2, 4, 2
# phase 7: train steps at batch samples_per_gpu over phase 6's viewpoints
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
# phase 8: the synthetic VLN environment, the policy's vocabulary and text
# length (tools/test_vln.py's R2R model), the lockstep eval batch
AGENT_SCANS, AGENT_NODES, AGENT_EPISODES = 3, 9, 16
AGENT_VOCAB, AGENT_TEXT_LEN, AGENT_BATCH = 4000, 80, 8
# phase 8's rates: the same graphs and volumes with this many episodes (the
# first AGENT_EPISODES those of the checks), passes at batch 1 and
# AGENT_BATCH interleaved, each pass a window of seconds
AGENT_RATE_EPISODES, AGENT_RATE_PASSES = 256, 2
# R2R's reference paths: 4 to 6 edges (Anderson et al., CVPR 2018, sec. 3)
R2R_PATH_EDGES = "4-6"
# phase 9: the agent's training on phase 8's environment and volumes; the
# JAX CLIs' defaults (pretrain batch 16 at lr 5e-5; DAgger with student
# actions half the time at lr 1e-4), lockstep rollouts of 8 episodes,
# updates of 8 decision steps
PRETRAIN_BATCH, PRETRAIN_LR = 16, 5e-5
DAGGER_SAMPLE_PROB, DAGGER_EPISODE_BATCH, DAGGER_UPDATE_BATCH = 0.5, 8, 8
DAGGER_LR = 1e-4
AGENT_TRAIN_WARMUP, AGENT_TRAIN_UPDATES = 2, 8


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
    timed train steps, and those of the remat and capacity steps."""
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
    worst_loss = worst_relative(lc, lh)
    bad = [k for k in lh if abs(lc[k] - lh[k]) > 1e-4 * abs(lh[k]) + 1e-7]
    print(f"train step card vs CPU (vocc.py widths, occupancy grid {grid}, "
          f"host matcher): matched queries equal ({mc.numel()} GT slots), "
          f"largest relative loss difference {worst_loss[0]:.3e} "
          f"({worst_loss[1]}) (rtol 1e-4) "
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
    return fwd, bwd, remat_and_capacity(ver, tc, batches[0], card)


def worst_relative(got, ref):
    """(largest relative difference, its key) over the losses: every
    metric but ``grad_norm`` and ``sca_overflow``."""
    return max((abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12), k)
               for k in ref if k not in ("grad_norm", "sca_overflow"))


def card_step(cfg, tc, host_batch, record=None, pin=None):
    """One ``make_train_step`` on the card from the seed-0 weights: (the
    matched query of every GT slot of every match the step made, its
    metrics, every parameter's gradient, forward and backward launches and
    the nq of their last launches).  ``record`` / ``pin``: the ReLU masks
    (``utils.params.relu_masks``)."""
    from unittest import mock

    import torch

    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.train import (create_train_state, make_train_step,
                                         objective, to_device)
    from vln_ver_tpu_torch.utils.params import grads_by_name, relu_masks

    matches, inner = [], objective._match

    def match(*args, **kw):
        out = inner(*args, **kw)
        matches.append(out.cpu().flatten())
        return out

    model = build_model(cfg, "cuda", seed=0)
    state = create_train_state(model, tc)
    batch = to_device(host_batch, torch.device("cuda"))
    KERNEL.launches = KERNEL_BWD.launches = 0
    KERNEL.last_nq = KERNEL_BWD.last_nq = None
    with mock.patch.object(objective, "_match", match), \
            relu_masks(model, record=record, pin=pin):
        metrics = make_train_step(cfg, tc)(state, batch, seed=1)
    torch.cuda.synchronize()
    return (torch.cat(matches), {k: float(v) for k, v in metrics.items()},
            {n: g.cpu() for n, g in grads_by_name(model).items()},
            (KERNEL.launches, KERNEL_BWD.launches),
            (KERNEL.last_nq, KERNEL_BWD.last_nq))


def hold_step(name, got, ref, rtol, grad_tol, card):
    """Fail unless two ``card_step`` results agree: the same matched
    queries, the losses within ``rtol``, each parameter's gradient within
    ``grad_tol`` of its L2 norm."""
    import torch
    if not torch.equal(got[0], ref[0]):
        fail(f"{name}: matched queries differ in "
             f"{int((got[0] != ref[0]).sum())} of {ref[0].numel()} slots")
    loss_rel, loss_key = worst_relative(got[1], ref[1])
    bad = [k for k in ref[1] if k not in ("grad_norm", "sca_overflow")
           and abs(got[1][k] - ref[1][k]) > rtol * abs(ref[1][k]) + 1e-7]
    worst, failed = (0.0, None), []
    for n, g in ref[2].items():
        diff = float(torch.linalg.vector_norm((got[2][n] - g).double()))
        norm = float(torch.linalg.vector_norm(g.double()))
        if diff > grad_tol * norm + 1e-7:
            failed.append(n)
        if norm > 0 and diff / norm > worst[0]:
            worst = (diff / norm, n)
    print(f"{name}: matched queries equal ({ref[0].numel()} slots), "
          f"largest relative loss difference {loss_rel:.3e} ({loss_key}) "
          f"(rtol {rtol}), worst relative gradient L2 difference "
          f"{worst[0]:.3e} ({worst[1]}) (within {grad_tol}); launches "
          f"forward + backward {got[3]} at nq {got[4]} "
          f"{'ok' if not bad and not failed else 'FAIL'} [{card}]")
    if bad or failed:
        fail(f"{name}: losses {bad}, gradients {failed[:5]}")


def remat_and_capacity(ver, tc, host_batch, card):
    """Phase 7's remat and capacity steps; returns their launches.

    Every step here runs with cuDNN's deterministic algorithms: the
    upsampler's backward convolutions otherwise add in a varying order,
    which moved the upsampler's weight gradients by 1.255e-04 of their
    norm between two steps of identical forwards, more than the remat
    check's 1e-4."""
    import torch
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _remat_and_capacity(ver, tc, host_batch, card)
    finally:
        torch.backends.cudnn.deterministic = saved


def _remat_and_capacity(ver, tc, host_batch, card):
    base = card_step(ver, tc, host_batch)
    remat = card_step(dataclasses.replace(ver, remat_encoder=True), tc,
                      host_batch)
    layers = ver.encoder_layers
    if remat[3] != (2 * layers, layers):
        fail(f"the remat step launched the forward and backward kernels "
             f"{remat[3]} times, expected ({2 * layers}, {layers})")
    hold_step("train step with remat_encoder vs without (card)", remat,
              base, 1e-5, 1e-4, card)
    # dense vs capacity: the host matcher, dropout off, the capacity step's
    # ReLUs on the dense step's masks (the two forwards differ by rounding)
    tc_host = dataclasses.replace(tc, matcher="host")
    quiet = dataclasses.replace(ver, dropout_rate=0.0)
    masks = []
    dense = card_step(quiet, tc_host, host_batch, record=masks)
    sparse = card_step(dataclasses.replace(quiet,
                                           sca_query_capacity=SPARSE_K),
                       tc_host, host_batch, pin=masks)
    if sparse[1]["sca_overflow"] or sparse[3] != (layers, layers) \
            or sparse[4] != (SPARSE_K, SPARSE_K):
        fail(f"the capacity step: overflow {sparse[1]['sca_overflow']}, "
             f"launches {sparse[3]} at nq {sparse[4]}, expected "
             f"({layers}, {layers}) at nq {SPARSE_K}")
    hold_step(f"train step with sca_query_capacity={SPARSE_K} vs dense "
              f"(card)", sparse, dense, 1e-4, 1e-3, card)
    return dict(fwd_remat=remat[3][0], bwd_remat=remat[3][1],
                fwd_capacity=sparse[3][0], bwd_capacity=sparse[3][1])


def drive(bev_only, host_batches, ver, device):
    """Upload each batch of host arrays, run ``bev_only`` on them and bring
    the volumes back in the dump layout: (volumes (N, C, Z, H, W), seconds,
    the largest sca_overflow)."""
    import torch

    from vln_ver_tpu_torch.ver_writer import volumes_from_bev
    vols, overflow = [], 0
    t0 = time.perf_counter()
    for arrays in host_batches:
        bev, ovf = bev_only(*(torch.from_numpy(a).to(device)
                              for a in arrays))
        overflow = max(overflow, int(ovf))
        vols.append(volumes_from_bev(bev.float().cpu().numpy(), ver))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return np.concatenate(vols), time.perf_counter() - t0, overflow


def counted(bev_only, host_batches, ver):
    """One warm-up run, then one run on the card with the kernels' counts
    set to 0 just before it; returns (volumes, seconds, overflow, forward
    launches, nq of the last launch, peak device MiB)."""
    import torch

    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    drive(bev_only, host_batches, ver, "cuda")
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = KERNEL_BWD.launches = 0
    KERNEL.last_nq = None
    vols, secs, ovf = drive(bev_only, host_batches, ver, "cuda")
    if KERNEL_BWD.launches:
        fail(f"an inference path launched the backward kernel "
             f"{KERNEL_BWD.launches} times")
    return (vols, secs, ovf, KERNEL.launches, KERNEL.last_nq,
            torch.cuda.max_memory_allocated() / 2 ** 20)


def batches_of(*arrays):
    return [tuple(a[b0:b0 + BATCH] for a in arrays)
            for b0 in range(0, N_VIEWPOINTS, BATCH)]


def sparse_lift(model, ver, feats, w2p, shift, dense_vols, dense_rate,
                card):
    """Phase 4b; returns its numbers for the kernels line."""
    import torch

    from vln_ver_tpu_torch.geometry import max_visible_queries
    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL

    need = max_visible_queries(w2p, shift, ver.bev_z, ver.bev_h, ver.bev_w,
                               ver.pc_range)
    print(f"sparse lift: max_visible_queries of the {N_VIEWPOINTS} "
          f"viewpoints = {need} of {ver.bev_num} (capacity {SPARSE_K})")
    if need > SPARSE_K:
        fail(f"a camera sees {need} queries, more than the capacity "
             f"{SPARSE_K}")
    cap = dataclasses.replace(ver, sca_query_capacity=SPARSE_K)
    sparse = build_model(cap, "cuda", seed=0)
    sparse.load_state_dict(model.state_dict(), strict=True)
    vols, secs, ovf, launches, nq, peak = counted(
        make_bev_only(sparse), batches_of(feats, w2p, shift), ver)
    n_batches = -(-N_VIEWPOINTS // BATCH)
    if ovf:
        fail(f"sparse lift sca_overflow={ovf}")
    if launches != ver.encoder_layers * n_batches or nq != SPARSE_K:
        fail(f"the sparse lift launched deform_attn_2d {launches} times, "
             f"the last at nq={nq}; expected {ver.encoder_layers} x "
             f"{n_batches} batches at nq={SPARSE_K}")
    err, ok = close(torch.from_numpy(vols), torch.from_numpy(dense_vols),
                    1e-5, 1e-5)
    print(f"sparse lift volumes vs the dense lift's: max_abs_err={err:.3e} "
          f"(rtol=1e-5, atol=1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the sparse lift's volumes disagree with the dense lift's")
    weights_mib = sum(p.numel() * p.element_size()
                      for p in sparse.parameters()) / 2 ** 20
    print(f"sparse lift: {N_VIEWPOINTS} volumes in {secs:.4f}s = "
          f"{N_VIEWPOINTS / secs:.2f} volumes/s at batch {BATCH} (dense "
          f"{dense_rate:.2f} in phase 4), peak device memory {peak:.1f} "
          f"MiB ({weights_mib:.1f} MiB of it the dense model's weights, "
          f"kept for phase 6), deform launches {launches} at nq={nq} "
          f"[{card}]")
    # the kernel at the sparse lift's shape against the dense lift's
    hw, heads, d, P = ver.feat_h * ver.feat_w, ver.num_heads, \
        ver.head_dim, ver.sca_num_points
    times = {}
    with torch.inference_mode():
        for n in (SPARSE_K, ver.bev_num):
            v, loc, w = deform_inputs(BATCH * ver.num_cams, hw, heads, d, n,
                                      P, torch.float32, 30, "cuda")
            times[n] = (time_graph_ms(lambda: KERNEL(
                v, ((ver.feat_h, ver.feat_w),), loc, w)),
                *deform_bound(v, loc, w, (ver.feat_h, ver.feat_w)))
    (ms_k, bound_k, by_k), (ms_d, _, _) = times[SPARSE_K], times[ver.bev_num]
    print(f"deform_attn_2d B={BATCH} fp32 at nq={SPARSE_K}: {ms_k:.4f} ms "
          f"(graph), bound {bound_k:.4f} ms ({by_k}), "
          f"{100 * bound_k / ms_k:.1f}% of bound; at nq={ver.bev_num}: "
          f"{ms_d:.4f} ms ({ms_d / ms_k:.2f}x) [{card}]")
    return dict(launches_dump_sparse=launches,
                volumes_per_s_sparse=N_VIEWPOINTS / secs,
                ms_b4_nq256=ms_k, ms_b4_nq900=ms_d,
                bound_ms_b4_nq256=bound_k)


def int8_upload(model, cpu_model, ver, feats, w2p, shift, dense_vols, card):
    """Phase 4c; returns its numbers for the kernels line."""
    import torch

    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.ver_writer import dequantize_int8, quantize_int8

    batches = [(*quantize_int8(f), m, s)
               for f, m, s in batches_of(feats, w2p, shift)]

    def int8_path(bev_only):
        def run(q, scale, m, s):
            return bev_only(dequantize_int8(q, scale, ver.dtype), m, s)
        return run

    vols, secs, ovf, launches, nq, peak = counted(
        int8_path(make_bev_only(model)), batches, ver)
    if ovf or launches != ver.encoder_layers * len(batches):
        fail(f"int8 path: overflow {ovf}, {launches} launches")
    t0 = time.perf_counter()
    cpu_vols, _, _ = drive(int8_path(make_bev_only(cpu_model)), batches,
                           ver, "cpu")
    cpu_s = time.perf_counter() - t0
    err, ok = close(torch.from_numpy(vols), torch.from_numpy(cpu_vols),
                    1e-4, 1e-4)
    print(f"int8 upload volumes card vs CPU int8 run ({N_VIEWPOINTS} "
          f"viewpoints): max_abs_err={err:.3e} (rtol=1e-4, atol=1e-4) "
          f"{'ok' if ok else 'FAIL'}; the CPU took {cpu_s:.2f}s")
    if not ok:
        fail("the card's int8 volumes disagree with the CPU's")
    dev_fp32 = float(np.abs(vols - dense_vols).max())
    per_vol = sum(a[:1].nbytes for a in batches[0])
    fp32_per_vol = feats[:1].nbytes + w2p[:1].nbytes + shift[:1].nbytes
    print(f"int8 upload: {N_VIEWPOINTS} volumes in {secs:.4f}s = "
          f"{N_VIEWPOINTS / secs:.2f} volumes/s at batch {BATCH}, peak "
          f"device memory {peak:.1f} MiB, deform launches {launches}; "
          f"largest deviation from the fp32 volumes {dev_fp32:.3e} (of "
          f"|v| <= {float(np.abs(dense_vols).max()):.3f}); upload "
          f"{per_vol} B a volume (fp32 features: {fp32_per_vol} B) [{card}]")
    return dict(launches_dump_int8=launches,
                volumes_per_s_int8=N_VIEWPOINTS / secs,
                upload_bytes_per_volume_int8=per_vol,
                int8_max_dev_from_fp32=dev_fp32)


def image_path(model, ver, w2p, shift, card):
    """Phase 4d; returns its numbers for the kernels line."""
    import torch

    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.models.vit import vit_feature_frontend, vit_for_ver

    def vit_on(device):
        gen = torch.Generator().manual_seed(1)
        return vit_for_ver(ver, VIT_PATCH, VIT_LAYERS, VIT_HEADS).init_weights(
            gen).to(device).eval()

    vit = vit_on("cuda")
    size = vit.image_size
    images = np.random.default_rng(4).integers(
        0, 256, (N_VIEWPOINTS, ver.num_cams, size, size, 3)).astype(np.uint8)
    batches = batches_of(images, w2p, shift)
    vols, secs, ovf, launches, nq, peak = counted(
        make_bev_only(model, vit), batches, ver)
    if ovf or launches != ver.encoder_layers * len(batches) \
            or nq != ver.bev_num:
        fail(f"image path: overflow {ovf}, {launches} launches, the last "
             f"at nq={nq}")
    # two stages on the card: the ViT's features to the host, then the
    # feature path
    with torch.inference_mode():
        feats = np.concatenate([vit_feature_frontend(
            vit, torch.from_numpy(im).cuda()).cpu().numpy()
            for im, _, _ in batches])
    two, _, _ = drive(make_bev_only(model), batches_of(feats, w2p, shift),
                      ver, "cuda")
    err, ok = close(torch.from_numpy(vols), torch.from_numpy(two), 1e-5,
                    1e-5)
    print(f"fused image path vs two stages on the card (ViT, then the "
          f"feature path): max_abs_err={err:.3e} (rtol=1e-5, atol=1e-5) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the fused image path disagrees with its two stages")
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_feats = vit_feature_frontend(vit_on("cpu"),
                                         torch.from_numpy(images[:1]))
    cpu_s = time.perf_counter() - t0
    err, ok = close(torch.from_numpy(feats[:1]), cpu_feats, 1e-4, 1e-4)
    print(f"ViT-B/16 features card vs CPU (one viewpoint, {ver.num_cams} "
          f"views): max_abs_err={err:.3e} (rtol=1e-4, atol=1e-4) "
          f"{'ok' if ok else 'FAIL'}; the CPU took {cpu_s:.2f}s")
    if not ok:
        fail("the card's ViT features disagree with the CPU's")
    x = torch.from_numpy(images[:BATCH]).cuda()
    with torch.inference_mode():
        vit_ms = time_ms(lambda: vit_feature_frontend(vit, x), iters=10,
                         warmup=2)
    per_vol = sum(a[:1].nbytes for a in batches[0])
    print(f"image path: {N_VIEWPOINTS} volumes in {secs:.4f}s = "
          f"{N_VIEWPOINTS / secs:.2f} volumes/s at batch {BATCH} "
          f"(ViT-B/{VIT_PATCH}, {VIT_LAYERS} layers, {VIT_HEADS} heads, "
          f"{size} x {size}), ViT {vit_ms:.3f} ms of device time per batch "
          f"(CUDA events), peak device memory {peak:.1f} MiB, upload "
          f"{per_vol} B a volume, deform launches {launches} [{card}]")
    return dict(launches_images=launches,
                volumes_per_s_images=N_VIEWPOINTS / secs,
                vit_ms_per_batch=vit_ms,
                upload_bytes_per_volume_images=per_vol)


def agent_volumes(ver, graphs, vols, card):
    """Phase 8, step 2: one synthetic viewpoint per token through the VER
    product path on the card (the get_occ.py model of phase 4, its seed-0
    weights, batch 4, the last batch padded and the padding dropped);
    each dump-layout volume read back as load_ver_features reads it.
    Returns (token -> (900, C) volume, forward launches, volumes/s)."""
    from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel
    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.models import build_model

    tokens = sorted(vols)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal(
        (len(tokens), ver.num_cams, ver.feat_h, ver.feat_w,
         ver.in_channels)).astype(np.float32)
    # each camera rig stands at its viewpoint's graph position
    pos = np.stack([graphs[t.split("_")[0]].positions[t.split("_")[1]]
                    for t in tokens]).astype(np.float32)
    w2p = np.stack([np.stack([
        make_pinhole_world2pixel(70.0, deg * 360.0 / ver.num_cams, p)
        for deg in range(ver.num_cams)]) for p in pos]).astype(np.float32)
    pad = -len(tokens) % BATCH
    arrays = [np.concatenate([a, np.repeat(a[-1:], pad, 0)])
              for a in (feats, w2p, pos)]
    batches = [tuple(a[b0:b0 + BATCH] for a in arrays)
               for b0 in range(0, len(arrays[0]), BATCH)]
    model = build_model(ver, "cuda", seed=0)
    dumped, secs, ovf, launches, nq, _ = counted(make_bev_only(model),
                                                 batches, ver)
    del model
    want = ver.encoder_layers * len(batches)
    if ovf or launches != want or nq != ver.bev_num:
        fail(f"agent volumes: overflow {ovf}, {launches} forward launches "
             f"(expected {want}), the last at nq={nq}")
    out = {}
    for tok, v in zip(tokens, dumped[:len(tokens)]):
        flat = v.reshape(v.shape[0], -1).T.astype(np.float32)
        if flat.shape != (ver.bev_num, ver.embed_dims) \
                or not np.isfinite(flat).all():
            fail(f"agent volume {tok}: {flat.shape}, finite "
                 f"{np.isfinite(flat).all()}")
        out[tok] = flat
    rate = len(tokens) / secs
    print(f"agent volumes: {len(tokens)} viewpoints through the VER path "
          f"in {secs:.4f}s = {rate:.2f} volumes/s at batch {BATCH} "
          f"({len(batches)} batches, {pad} padding), deform launches "
          f"{launches}, backward 0 [{card}]")
    return out, launches, rate


def _check_metrics(per_episode, what):
    for i, m in enumerate(per_episode):
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        bad += [k for k in ("success", "oracle_success")
                if m[k] not in (0.0, 1.0)]
        bad += [k for k in ("spl", "ndtw", "sdtw", "cls")
                if not 0.0 <= m[k] <= 1.0 + 1e-9]
        bad += [k for k in ("nav_error", "traj_length") if m[k] < 0]
        if bad:
            fail(f"{what}: episode {i} metrics out of range {bad}: {m}")


def busy_share(fn, what, card):
    """``fn()`` once under torch.profiler: the device's busy share of the
    wall time, printed with the largest kernels (None where the profiler
    recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    if not dev_us:
        print(f"{what} device busy share: not measured (the profiler "
              "recorded no device time)")
        return None
    print(f"{what} device busy share: {100 * dev_us / 1e6 / wall:.1f}% of "
          f"{1e3 * wall:.3f} ms wall (profiled run) [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    return dev_us / 1e6 / wall


def agent_profile(policy, env, cfg, card):
    """One batch-8 rollout under torch.profiler: the device's busy share
    of the wall time and its largest kernels."""
    from vln_ver_tpu_torch.agent.rollout import run_episodes_batched
    return busy_share(lambda: run_episodes_batched(
        policy, env, list(range(AGENT_BATCH)), cfg),
        f"agent batch-{AGENT_BATCH} rollout", card)


def agent_path(ver, card):
    """Phase 8; returns its numbers for the kernels line."""
    import tempfile

    import torch

    from vln_ver_tpu_torch.agent import replay
    from vln_ver_tpu_torch.agent.env import R2REnv, make_synthetic_vln
    from vln_ver_tpu_torch.agent.policy import PolicyConfig, build_policy
    from vln_ver_tpu_torch.agent.rollout import (episode_metrics, evaluate,
                                                 evaluate_batched,
                                                 mean_metrics,
                                                 run_episodes_batched)

    cfg = PolicyConfig(embed_dims=ver.embed_dims, vocab_size=AGENT_VOCAB,
                       max_text_len=AGENT_TEXT_LEN, bev_z=ver.bev_z,
                       bev_h=ver.bev_h, bev_w=ver.bev_w)
    # the generator draws the graphs and volumes before the episodes, so
    # the first AGENT_EPISODES are those of a run of AGENT_EPISODES
    with tempfile.TemporaryDirectory() as root:
        episodes, graphs, vols = make_synthetic_vln(
            root, num_scans=AGENT_SCANS, nodes_per_scan=AGENT_NODES,
            num_episodes=AGENT_RATE_EPISODES,
            bev_num=cfg.bev_z * cfg.bev_h * cfg.bev_w,
            embed_dims=cfg.embed_dims, vocab=AGENT_VOCAB,
            max_text_len=AGENT_TEXT_LEN, seed=0)
    vols, launches, vol_rate = agent_volumes(ver, graphs, vols, card)
    env = R2REnv(episodes[:AGENT_EPISODES], graphs, vols,
                 max_nodes=cfg.max_nodes)
    policy = build_policy(cfg, "cuda", seed=2)
    n_params = sum(p.numel() for p in policy.parameters())

    run_episodes_batched(policy, env, list(range(AGENT_BATCH)), cfg)  # warm
    per_ep = {}
    for batch in (1, AGENT_BATCH):
        per_ep[batch] = episode_metrics(
            policy, env, cfg, batch_size=None if batch == 1 else batch)
        _check_metrics(per_ep[batch], f"batch {batch}")
    if per_ep[AGENT_BATCH] != per_ep[1]:
        diff = [i for i, (a, b) in enumerate(zip(per_ep[1],
                                                 per_ep[AGENT_BATCH]))
                if a != b]
        fail(f"batched greedy metrics differ from the sequential run's in "
             f"episodes {diff}")
    # the entry points test_vln calls give the means of those episodes
    means = mean_metrics(per_ep[1])
    if evaluate(policy, env, cfg) != means or evaluate_batched(
            policy, env, cfg, batch_size=AGENT_BATCH) != mean_metrics(
                per_ep[AGENT_BATCH]):
        fail("evaluate / evaluate_batched disagree with the per-episode "
             "runs")
    print(f"agent eval: {AGENT_EPISODES} episodes, mean metrics "
          + json.dumps({k: round(v, 4) for k, v in means.items()})
          + f" (evaluate and evaluate_batched); batch {AGENT_BATCH} "
          "per-episode metrics equal batch 1's")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(launches_agent=launches, agent_volumes_per_s=vol_rate,
               agent_params=n_params, **agent_rates(
                   policy, R2REnv(episodes, graphs, vols,
                                  max_nodes=cfg.max_nodes), cfg, card))
    out["agent_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"agent peak device memory over the rate passes "
          f"{out['agent_peak_mib']:.1f} MiB [{card}]")
    out[f"agent_busy_share_b{AGENT_BATCH}"] = agent_profile(policy, env,
                                                           cfg, card)

    # card vs CPU: the batch-8 rollouts of every episode recorded on the
    # card, each policy call replayed on the CPU port with the same weights
    # and inputs
    with replay.PolicyCalls(policy, record=True) as rec:
        for lo in range(0, AGENT_EPISODES, AGENT_BATCH):
            run_episodes_batched(policy, env, list(range(
                lo, min(lo + AGENT_BATCH, AGENT_EPISODES))), cfg)
    # no parameter requires grad: FlopCounterMode's module tracker (in
    # agent_step_times) fails on a view of one made without autograd
    cpu_policy = build_policy(cfg, "cpu", seed=2).requires_grad_(False)
    t0 = time.perf_counter()
    try:
        held = replay.replay(rec.calls, cpu_policy)
    except AssertionError as e:
        fail(str(e))
    print(f"agent card vs CPU ({held['steps']} policy calls of batch-"
          f"{AGENT_BATCH} rollouts, {n_params} parameters): max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in held["worst"].items())
          + f" (rtol={replay.RTOL}, atol={replay.ATOL}, -1e9 entries "
          f"equal); greedy actions equal in {held['compared']} rows with a "
          f"top-2 margin over {replay.MARGIN} (smallest "
          f"{held['min_margin']:.3e}), {held['near']} near-tie rows "
          f"skipped; the CPU took {time.perf_counter() - t0:.2f}s ok")
    out["agent_max_abs_err_logits"] = held["worst"]["logits"]
    out.update(agent_step_times(policy, cpu_policy, rec.calls, card))
    return out, (cfg, episodes, graphs, vols)


def agent_rates(policy, env, cfg, card):
    """Phase 8's rates: greedy evaluation of every episode of ``env`` at
    batch 1 and in lockstep batches of AGENT_BATCH, AGENT_RATE_PASSES
    passes of each, interleaved, from volumes in host memory to the
    metrics.  Per pass: decision steps/s, episodes/s, decisions per
    episode (beside the expert paths' edges and R2R's), the share of
    batch rows still running, device ms per policy call (CUDA events; the
    first call of an episode or batch also encodes the instruction) and
    host ms per call by stage.  Each pass's per-episode metrics must be in
    range, and the batched ones equal the sequential ones."""
    import torch

    from vln_ver_tpu_torch.agent.replay import PolicyCalls
    from vln_ver_tpu_torch.agent.rollout import episode_metrics

    n = len(env.episodes)
    expert = float(np.mean([len(ep["path"]) - 1 for ep in env.episodes]))
    out = {}
    for p in range(AGENT_RATE_PASSES):
        seq = None
        for batch in (1, AGENT_BATCH):
            times = {}
            with PolicyCalls(policy, timed=True) as hooks:
                t0 = time.perf_counter()
                per_ep = episode_metrics(
                    policy, env, cfg,
                    batch_size=None if batch == 1 else batch, times=times)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                dev_ms = np.asarray(hooks.device_ms())
                first = np.asarray(hooks.first)
            _check_metrics(per_ep, f"rate pass {p} batch {batch}")
            if seq is None:
                seq = per_ep
            elif per_ep != seq:
                fail(f"rate pass {p}: batch-{batch} per-episode metrics "
                     f"differ from the sequential run's")
            calls, dec = times["policy_calls"], times["decisions"]
            host = {k: 1e3 * times[k] / calls
                    for k in ("env", "memory", "upload", "policy")}
            rows = calls * batch
            row = dict(steps_per_s=dec / secs, episodes_per_s=n / secs,
                       seconds=secs, decisions=dec, policy_calls=calls,
                       decisions_per_episode=dec / n,
                       active_row_share=dec / rows,
                       device_ms_first=float(np.median(dev_ms[first])),
                       device_ms_later=float(np.median(dev_ms[~first])),
                       **{f"host_{k}_ms": v for k, v in host.items()})
            print(f"agent eval pass {p} batch {batch}: {n} episodes, {dec} "
                  f"decision steps ({dec / n:.3f} an episode; expert paths "
                  f"{expert:.3f} edges, R2R's {R2R_PATH_EDGES}) in {calls} "
                  f"policy calls, {100 * dec / rows:.1f}% of the batch rows "
                  f"running; {secs:.4f}s = {dec / secs:.2f} decision "
                  f"steps/s, {n / secs:.3f} episodes/s; device ms per call "
                  f"(CUDA events, median) {row['device_ms_later']:.3f} "
                  f"later, {row['device_ms_first']:.3f} first (instruction "
                  f"encoded; {int(first.sum())} calls); host ms per call: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
                  + f" [{card}]")
            for k, v in row.items():
                out.setdefault(f"agent_{k}_b{batch}", []).append(v)
    out["agent_expert_path_edges"] = expert
    return out


def agent_step_times(policy, cpu_policy, calls, card):
    """The policy step alone, on the recorded inputs of a later step (the
    instruction features passed in), at batch 1 and 8: device ms in a CUDA
    graph (the host's launches left out) and eager, beside its bound, the
    larger of the bytes over 3.35 TB/s and the GEMM operations (counted by
    FlopCounterMode on the CPU) over the 67 TFLOP/s fp32 peak.  The bytes
    are those the step moves, found on the CPU by watching every op's
    operands: the weights and inputs it reads, once each (a later step
    never runs the text encoder), and the outputs it writes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    from vln_ver_tpu_torch.agent.replay import tensors

    class Reads(TorchDispatchMode):
        """The storages of every op's tensor operands."""

        def __init__(self):
            super().__init__()
            self.ptrs = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.ptrs.update(ptr(t) for t in tree_leaves((args, kwargs))
                             if isinstance(t, torch.Tensor))
            return func(*args, **kwargs)

    def ptr(t):
        return t.untyped_storage().data_ptr()

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    later = [c for c in calls if c[1].get("text_feats") is not None]
    args, kwargs, _ = (later or calls)[0]
    weights = [*cpu_policy.parameters(), *cpu_policy.buffers()]
    out = {}
    for batch in (1, AGENT_BATCH):
        a, k = tensors(lambda t: t[:batch], (args, kwargs))
        with torch.no_grad(), FlopCounterMode(display=False) as flops, \
                Reads() as reads:
            res = cpu_policy(*a, **k)
        ins = [t for t in tree_leaves((a, k)) if isinstance(t, torch.Tensor)]
        read_w = [w for w in weights if ptr(w) in reads.ptrs]
        read_in = [t for t in ins if ptr(t) in reads.ptrs]
        written = [t for t in tree_leaves(tuple(res))
                   if isinstance(t, torch.Tensor)
                   and ptr(t) not in {ptr(i) for i in ins}]
        moved = nbytes(read_w) + nbytes(read_in) + nbytes(written)
        with torch.inference_mode():
            ga, gk = tensors(lambda t: t.cuda(), (a, k))
            graph_ms = time_graph_ms(lambda: policy(*ga, **gk), launches=10,
                                     replays=10)
            eager_ms = time_ms(lambda: policy(*ga, **gk), iters=20,
                               warmup=3)
        ops = flops.get_total_flops()
        bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / FP32_FLOP_PER_S
        bound = max(bytes_ms, ops_ms)
        print(f"agent policy step alone at batch {batch} (a later step, "
              f"text features passed in): {graph_ms:.4f} ms in a CUDA graph, "
              f"{eager_ms:.4f} ms eager; bound {bound:.4f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}: "
              f"{moved / 1e6:.1f} MB moved, {nbytes(read_w) / 1e6:.1f} MB "
              f"of it the {sum(w.numel() for w in read_w)} of "
              f"{sum(w.numel() for w in weights)} weights read; "
              f"{ops / 1e9:.2f} GFLOP of GEMMs), "
              f"{100 * bound / graph_ms:.1f}% of bound in the graph [{card}]")
        out.update({f"agent_step_graph_ms_b{batch}": graph_ms,
                    f"agent_step_eager_ms_b{batch}": eager_ms,
                    f"agent_step_bound_ms_b{batch}": bound,
                    f"agent_step_bytes_b{batch}": moved,
                    f"agent_step_gflop_b{batch}": ops / 1e9})
    return out


def agent_hold(name, cpu_model, card_model, loss_of, card):
    """Phase 9: one update's losses and gradients on the card against the
    CPU's, from the same weights and batch, dropout off, the card's ReLUs
    pinned to the CPU run's masks (agent/replay.py's bounds).  Returns the
    GFLOP of the update (forward and backward, counted on the CPU by
    FlopCounterMode)."""
    from torch.utils.flop_counter import FlopCounterMode

    from vln_ver_tpu_torch.agent.replay import (GRAD_REL_L2, LOSS_RTOL,
                                                hold_update, loss_and_grads)
    masks = []
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops:
        ref = loss_and_grads(cpu_model, loss_of(cpu_model, "cpu"),
                             record=masks)
    cpu_s = time.perf_counter() - t0
    got = loss_and_grads(card_model, loss_of(card_model, "cuda"), pin=masks)
    try:
        held = hold_update(got, ref)
    except AssertionError as e:
        fail(f"{name}: {e}")
    gflop = flops.get_total_flops() / 1e9
    print(f"{name} card vs CPU (one update, dropout off, {got['flips']} "
          f"ReLU elements pinned to the CPU's masks): losses "
          + ", ".join(f"{k} {v:.6f}" for k, v in got["parts"].items())
          + f"; worst relative loss difference {held['loss'][0]:.3e} "
          f"({held['loss'][1]}) (rtol {LOSS_RTOL}); worst relative gradient "
          f"L2 difference {held['grad'][0]:.3e} ({held['grad'][1]}), global "
          f"norm {ref['gnorm']:.6f} within {held['gnorm']:.3e} (bound "
          f"{GRAD_REL_L2}); {gflop:.2f} GFLOP an update (forward and "
          f"backward); the CPU took {cpu_s:.2f}s ok [{card}]")
    return gflop, held


def stage_split(stages, n):
    """ms per update of each stage, from the ``agent.update.mark`` events of
    ``n`` updates: "start", "upload", "forward", "backward", "optimizer"."""
    import torch
    torch.cuda.synchronize()
    split = {}
    for (_, a), (name, b) in zip(stages, stages[1:]):
        if name != "start":
            split[name] = split.get(name, 0.0) + a.elapsed_time(b) / n
    return split


def timed_updates(name, updates, lossy, decisions_per_update, card,
                  stages, times=None):
    """AGENT_TRAIN_WARMUP updates of the generator ``updates``, then
    AGENT_TRAIN_UPDATES timed ones; every loss finite.  Returns the
    numbers of the window."""
    import torch
    losses = [lossy(next(updates)) for _ in range(AGENT_TRAIN_WARMUP)]
    torch.cuda.synchronize()
    stages.clear()
    before = dict(times or {})
    t0 = time.perf_counter()
    for _ in range(AGENT_TRAIN_UPDATES):
        losses.append(lossy(next(updates)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    host = [{k: float(v) for k, v in parts.items()} | {"loss": float(loss)}
            for loss, parts in losses]
    bad = [i for i, m in enumerate(host)
           if not all(np.isfinite(v) for v in m.values())]
    if bad:
        fail(f"{name}: non-finite losses at updates {bad}: {host}")
    split = stage_split(stages, AGENT_TRAIN_UPDATES)
    rollout = {}
    if times is not None:
        # the window's rollouts, and (for the steady state) every rollout
        # so far: the warm-up's and the window's
        win = {k: v - before.get(k, 0) for k, v in times.items()}
        split = {"rollout": 1e3 * win["rollout"] / AGENT_TRAIN_UPDATES,
                 **split}
        calls = times["policy_calls"]
        rollout = dict(window_rollouts=win["rollouts"],
                       rollouts=times["rollouts"], sampled=times["sampled"],
                       policy_calls=calls, decisions=times["decisions"],
                       **{f"host_{k}_ms": 1e3 * times[k] / calls
                          for k in ("env", "memory", "upload", "policy")})
    rate = AGENT_TRAIN_UPDATES / secs
    print(f"{name}: {AGENT_TRAIN_UPDATES} updates in {secs:.4f}s = "
          f"{rate:.3f} updates/s, {rate * decisions_per_update:.2f} "
          f"decision steps trained/s; ms per update: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + " (rollout on the host clock, the rest between CUDA events); "
          f"losses " + " ".join(f"{m['loss']:.4f}" for m in host)
          + f" [{card}]")
    if rollout:
        # a rollout's records feed updates beyond the window: the steady
        # state pays its host seconds per decision collected, plus the
        # updates' seconds per decision trained
        per_dec = times["rollout"] / rollout["decisions"]
        upd = ((secs - win["rollout"])
               / (AGENT_TRAIN_UPDATES * decisions_per_update))
        rollout.update(rollout_ms_per_decision=1e3 * per_dec,
                       update_ms_per_decision=1e3 * upd,
                       steady_decisions_per_s=1 / (per_dec + upd))
        print(f"{name}: {rollout['window_rollouts']} rollouts in the "
              f"window; all {rollout['rollouts']} so far "
              f"({rollout['sampled']} with the student's actions): "
              f"{rollout['policy_calls']} policy calls for "
              f"{rollout['decisions']} decisions; host ms per call: "
              + ", ".join(f"{k[5:-3]} {v:.3f}" for k, v in rollout.items()
                          if k.startswith("host_"))
              + f"; {1e3 * per_dec:.3f} ms of rollout per decision "
              f"collected, {1e3 * upd:.3f} ms of update per decision "
              f"trained: {1 / (per_dec + upd):.2f} decision steps trained/s "
              f"in the steady state [{card}]")
    return dict(updates_per_s=rate, seconds=secs,
                decisions_per_s=rate * decisions_per_update,
                ms=split, losses=[m["loss"] for m in host], **rollout)


def moved(before, model):
    """The largest parameter change since ``before`` (fails if none)."""
    import torch
    with torch.no_grad():
        delta = max(float((p.cpu() - b).abs().max())
                    for p, b in zip(model.parameters(), before))
    if not delta > 0:
        fail("training left every parameter as it was")
    return delta


def agent_training(cfg, episodes, graphs, vols, card):
    """Phase 9: the agent's trainers at full width on phase 8's synthetic
    environment and VER volumes (no new forward launch).  Returns its
    numbers."""
    import tempfile

    import torch

    from vln_ver_tpu_torch.agent.env import R2REnv
    from vln_ver_tpu_torch.agent.policy import VLNPolicy, build_policy
    from vln_ver_tpu_torch.agent.pretrain import (VLNPretrainModel,
                                                  collect_teacher_trace,
                                                  init_pretrain_params,
                                                  mask_tokens, stack_records)
    from vln_ver_tpu_torch.agent.rollout import (episode_metrics,
                                                 evaluate_batched,
                                                 imitation_step_loss,
                                                 mean_metrics,
                                                 run_episodes_batched)
    from vln_ver_tpu_torch.agent.update import make_train_state
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.pretrain_vln import pretrain_updates
    from vln_ver_tpu_torch.train_vln import dagger_updates
    from vln_ver_tpu_torch.utils.checkpoint import load_model, save_model

    t_phase = time.perf_counter()
    KERNEL.launches = KERNEL_BWD.launches = 0
    env = R2REnv(episodes[:AGENT_EPISODES], graphs, vols,
                 max_nodes=cfg.max_nodes)
    records = [r for i in range(len(env.episodes))
               for r in collect_teacher_trace(env, i, cfg)]
    out = {"records": len(records)}

    # -- pretraining (VLNPretrainModel: the policy and the MLM head) -----
    masked = mask_tokens(torch.Generator().manual_seed(11), stack_records(
        records[:PRETRAIN_BATCH])["instruction"], cfg.vocab_size)

    def pretrain_loss_of(model, dev):
        batch = stack_records(records[:PRETRAIN_BATCH], dev)
        t = [m.to(dev) for m in masked]

        def fn():
            parts = model(batch, *t)
            return sum(parts.values()), parts
        return fn

    model = init_pretrain_params(VLNPretrainModel(cfg), 3)
    n_pre = sum(p.numel() for p in model.parameters())
    card_model = init_pretrain_params(VLNPretrainModel(cfg), 3).cuda()
    out["pretrain_gflop"], _ = agent_hold(
        f"agent pretraining ({n_pre} parameters, batch {PRETRAIN_BATCH})",
        model.eval(), card_model.eval(), pretrain_loss_of, card)
    del model
    model = card_model.train()
    before = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(0)
    stages = []
    updates = pretrain_updates(
        model, make_train_state(model, PRETRAIN_LR), records, PRETRAIN_BATCH,
        np.random.default_rng(0), torch.Generator("cuda").manual_seed(11),
        "cuda", stages=stages)
    out["pretrain"] = timed_updates(
        f"agent pretraining at batch {PRETRAIN_BATCH} (dropout on, "
        f"{len(records)} offline records)", updates, lambda u: u[1:],
        PRETRAIN_BATCH, card, stages)
    out["pretrain"]["max_param_change"] = moved(before, model)
    out["pretrain"]["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    stages.clear()
    out["pretrain"]["busy_share"] = busy_share(
        lambda: next(updates), "agent pretraining update", card)
    print(f"agent pretraining peak device memory "
          f"{out['pretrain']['peak_mib']:.1f} MiB, largest parameter change "
          f"{out['pretrain']['max_param_change']:.3e} [{card}]")
    del model, card_model, updates, before

    # -- imitation with DAgger (the policy: phase 8's weights) -----------
    policy = build_policy(cfg, "cuda", seed=2)
    gen = torch.Generator("cuda").manual_seed(7)
    _, traces = run_episodes_batched(
        policy, env, list(range(DAGGER_EPISODE_BATCH)), cfg, greedy=False,
        generator=gen, collect_teacher=True)
    dagger_recs = [r for t in traces for r in t][:DAGGER_UPDATE_BATCH]

    def imitation_loss_of(pol, dev):
        batch = stack_records(dagger_recs, dev)
        return lambda: imitation_step_loss(pol, batch)

    out["dagger_gflop"], _ = agent_hold(
        f"agent imitation ({sum(p.numel() for p in policy.parameters())} "
        f"parameters, {DAGGER_UPDATE_BATCH} steps of sampled rollouts)",
        build_policy(cfg, "cpu", seed=2), policy, imitation_loss_of, card)
    before = [p.detach().to("cpu", copy=True)
              for p in policy.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, stages = {}, []
    updates = dagger_updates(
        policy, make_train_state(policy, DAGGER_LR), env, cfg,
        np.random.default_rng(0), gen, "cuda",
        sample_prob=DAGGER_SAMPLE_PROB, episode_batch=DAGGER_EPISODE_BATCH,
        update_batch=DAGGER_UPDATE_BATCH, times=times, stages=stages)

    def lossy(u):
        float(u[1])          # as train_vln logs every update
        return u[1:]
    out["dagger"] = timed_updates(
        f"agent imitation with DAgger (sample prob {DAGGER_SAMPLE_PROB}, "
        f"episode batch {DAGGER_EPISODE_BATCH}, update batch "
        f"{DAGGER_UPDATE_BATCH}, dropout off)", updates, lossy,
        DAGGER_UPDATE_BATCH, card, stages, times)
    step = (AGENT_TRAIN_WARMUP + AGENT_TRAIN_UPDATES) * DAGGER_UPDATE_BATCH
    out["dagger"]["max_param_change"] = moved(before, policy)
    out["dagger"]["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"agent imitation peak device memory "
          f"{out['dagger']['peak_mib']:.1f} MiB, largest parameter change "
          f"{out['dagger']['max_param_change']:.3e} [{card}]")
    stages.clear()
    out["dagger"]["busy_share"] = busy_share(
        lambda: next(updates), "agent imitation update (its rollout "
        "included where the buffer runs short)", card)
    step += DAGGER_UPDATE_BATCH
    del updates, before

    # -- the handoff: save_model -> load_model -> evaluate_batched -------
    with tempfile.TemporaryDirectory() as root:
        save_model(os.path.join(root, "ckpt"), step, policy)
        fresh = VLNPolicy(cfg).cuda().eval()
        load_model(os.path.join(root, "ckpt"), fresh)
    same = all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), policy.state_dict().values()))
    per_ep = episode_metrics(fresh, env, cfg, batch_size=AGENT_BATCH)
    _check_metrics(per_ep, "handoff")
    means = evaluate_batched(fresh, env, cfg, batch_size=AGENT_BATCH)
    if not same or means != mean_metrics(per_ep):
        fail(f"handoff: weights equal {same}, evaluate_batched equal to the "
             f"per-episode means {means == mean_metrics(per_ep)}")
    print(f"agent handoff: save_model at step {step}, load_model, "
          f"evaluate_batched at batch {AGENT_BATCH} over {len(per_ep)} "
          "episodes: " + json.dumps({k: round(v, 4)
                                     for k, v in means.items()}) + " ok")
    out["launches_fwd"], out["launches_bwd"] = (KERNEL.launches,
                                                KERNEL_BWD.launches)
    if KERNEL.launches or KERNEL_BWD.launches:
        fail(f"phase 9 launched the deform kernels ({KERNEL.launches}, "
             f"{KERNEL_BWD.launches}): it trains on phase 8's volumes")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"agent training phase: {out['seconds']:.2f}s, deform launches "
          f"forward 0, backward 0 [{card}]")
    return out


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
        ("sparse nq=256 fp32", 6 * BATCH, 14, 14, 96, SPARSE_K, f32,
         (-0.1, 1.1)),
        ("sparse nq=256 bf16", 6 * BATCH, 14, 14, 96, SPARSE_K, bf16,
         (-0.1, 1.1)),
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
    dense_vols = np.concatenate(vols)

    # -- phase 4b-4d: the sparse lift, the int8 upload, the image path ----
    extra = sparse_lift(model, ver, feats, w2p, shift, dense_vols,
                        N_VIEWPOINTS / main_s, card)
    extra.update(int8_upload(model, cpu_model, ver, feats, w2p, shift,
                             dense_vols, card))
    del cpu_model
    extra.update(image_path(model, ver, w2p, shift, card))

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
    launches_train, bwd_launches_train, train_extra = training(
        ver, samples, card)

    # -- phase 8: VER volumes -> the VLN agent's greedy evaluation ---------
    agent, agent_env = agent_path(ver, card)
    print(json.dumps({"agent": {**agent, "card": card}}))

    # -- phase 9: the agent's training on phase 8's volumes -----------------
    agent_train = agent_training(*agent_env, card)
    print(json.dumps({"agent_train": {**agent_train, "card": card}}))

    ms, eager_ms, plain_ms, bound_ms, bound_by, floor_ms = timing[
        "B=1 float32"]
    ms4, eager_ms4, plain_ms4, bound_ms4, _, floor_ms4 = timing[
        "B=4 float32"]
    # "launches" in both entries is the count over the timed train steps
    # (phase 7, the training path); "launches_dump", "launches_eval" and
    # the rest are the counts of phases 4, 4b-4d, 6 and 7's remat and
    # capacity steps, each read from that run alone
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
        **extra,
        "launches_train_remat": train_extra["fwd_remat"],
        "launches_train_capacity": train_extra["fwd_capacity"],
        "launches_agent": agent["launches_agent"],
        "launches_agent_train": agent_train["launches_fwd"],
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
        "launches_dump_sparse": 0,
        "launches_dump_int8": 0,
        "launches_images": 0,
        "launches_train_remat": train_extra["bwd_remat"],
        "launches_train_capacity": train_extra["bwd_capacity"],
        "launches_agent": 0,
        "launches_agent_train": agent_train["launches_bwd"],
        "card": card,
    }]}))
    print(f"chip_smoke total: {time.perf_counter() - T_START:.2f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
