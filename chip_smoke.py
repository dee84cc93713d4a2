#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels, hold each against its plain
version and time it alone, then drive the port's paths once on one NVIDIA
GPU and hold them against the CPU: the VER volume path, the full forward
and eval path, the training path, the VLN agent's evaluation and training
paths, the VER server, the multi-process paths (in a process group of
one: the data and view grid, tensor parallelism, the multi-slice grid,
the pipeline), the temporal VER model with decoder_on_bev, the
BEVFormer-2D family and the 36-view headline model.

    python3 chip_smoke.py

The paths are checked here, not timed: the benchmark (``python -m
verbench.run``) times them.  The times this script prints are of the
hand-written kernels alone (phases 5, 5c, 5d and 12) and of the upsampler's
two routes (phase 5b).  Launch counts say which route served a call: a
kernel's ``launches`` counts its host launches, so a launch inside a
replayed CUDA graph is read from the recorder's ``decoder#graph_replays``
instead.

Phases (any failure exits nonzero, nothing is caught):
  1. require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from vln_ver_tpu_torch/csrc, time the build and
     print ptxas's registers and spills for every instantiation;
  3. hold the deformable-attention kernel, and its backward kernel
     (dvalue, dlocations, dweights), against the plain PyTorch version and
     its autograd at the full main-path shape (fp32 and bf16), at the eval
     path's (batch 2, phase 6) and at the edges of the launch plans: a
     10x20 map, bs=1, nq=57 and 901, B=8, one V stage (d=256), rows the
     TMA unit cannot take (d=3), far-out locations; and at the launches of
     phases 11 and 12 (PATH_SHAPES: P=4, d=32, a 15x15 map, nq=100 and
     225), fp32 and bf16; and at phase 13's 36-view launches
     (HEADLINE_SHAPES): the forward at 288 slots (batch 8) with nq=900 and
     192, its plain version computed in blocks of slots, and both kernels
     at 72 slots (batch 2) with nq=900 and 192, fp32 and bf16;
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
     of 4 within 1e-5; the kernel's graph time at nq=256 against nq=900;
  4c. the int8 upload (ver_writer.quantize_int8 on the host, dequantised on
     the card): the volumes against a CPU int8 run within 1e-4; the
     largest deviation from 4's fp32 volumes;
  4d. the fused image path (uint8 views -> ViT-B/16 -> lift in one call,
     get_occ.make_bev_only; 16 synthetic viewpoints of six 224 x 224 views,
     random ViT weights from seed 1): one viewpoint's ViT features against
     the CPU within 1e-4, the volumes against a two-stage run on the card
     (ViT, then the feature path) within 1e-5;
  5. time the kernel (CUDA events over a CUDA graph of launches, so the
     wrapper's host time is left out; and over eager launches, as a caller
     sees it) and its plain version at batch 1 and batch 4 of the main
     path's shapes, print each timed launch's plan, the bytes bound
     (``verbench.flops``, the benchmark's) and the shared-memory floor;
     then the same for the backward kernel against the plain version's
     autograd backward, with its own shared-memory floor and plan, and its
     dvalue and dlocations / dweights halves alone; then both kernels at
     PATH_SHAPES (graph time fp32 and bf16, the plain version and its
     autograd, the bounds and floors), and at HEADLINE_SHAPES the same
     (the forward alone at 288 slots);
  5b. the refine_occ upsampler's two routes at vocc.py width (768
     channels, the 4 x 15 x 15 grid to 120 x 120 in three stages, random
     weights from seed 0 with biases drawn non-zero), fp32 and bf16, batch
     8 and 2: ``models.head.OccUpsampler`` (the even-grid factorisation
     the model runs) against ``dense_reference`` (the reference's dense
     ConvTranspose3d stack on the same parameters): the full output and
     ``informative``'s even grid plus bias, then the gradients of the
     input, every weight and bias through each (fp32: outputs within rtol
     1e-4 / atol 1e-4, gradients within 1e-4 in relative L2; bf16: 2e-2
     in relative L2 for both); with autograd off, the z-major route
     (the assembly kernel, a launch a stage) against the same even
     cells at the same limits; and at batch 2 the factorised backward run
     twice under cudnn.deterministic, bitwise equal; stage 1's fp32
     weight gradient within 1e-5 of a float64 run in relative L2 (printed
     beside the 2D-convolution form's).  Print each route's
     device ms (CUDA events) forward, and forward with backward, beside
     its GFLOP a viewpoint (``verbench.flops.upsampler_flop``: 318.5 and
     1,672 at this width; a backward counted as twice the forward) and its
     share of the card's fp32 / bf16 peak; an ``upsampler`` JSON line;
  5c. the occupancy MLP kernel (csrc/occ_mlp.cu) at the headline's even
     grid (OCC_MLP_SHAPES: batch 1 and 8 of 60 x 60 cells x 35 planes of
     128 bf16 channels, 16 classes; random weights, biases and LayerNorm
     affines from seed 9): the bias cell's rows and the lattice, 2
     launches a call, against the eager chain (the ``ClsBranch`` module
     and ``ops.occ_mlp.lattice_plain``): the bias cell's logits, and the
     whole lattice against the eager chain's (built from the eager bias
     logits), no further from it than the eager chain is from the same
     chain in float64 (``branch_float64``); every odd cell the bias logits
     the kernel was given, bit for bit; the kernel timed (CUDA events)
     beside its bound (the rows read and the lattice written once) and the
     eager chain's time;
  5d. the upsampler's assembly kernel (csrc/up_assemble.cu) at the
     headline's widths (UP_ASSEMBLE_BATCHES: batch 1 and 8, bf16, 768
     channels, Z = 4, 15 x 15 to 60 x 60 in three stages; random weights
     from seed 11, biases drawn non-zero): each stage's phases and bias
     profile from the stage's own convolutions, the kernel's even grid
     against the plain assembly (``ops.up_assemble.assemble_plain``) bit
     for bit, a launch a stage; each stage's kernel timed (CUDA events
     over a CUDA graph of launches, and over eager launches) beside its
     bound (every tap and profile value read once, the even grid written
     once) and the plain assembly's time;
  6. run the eval path as ``python -m vln_ver_tpu_torch.test`` does
     (configs/verformer/vocc.py at full width, the same random weights
     from seed 0, 8 synthetic viewpoints with ground truth at the full
     35 x 120 x 120 occupancy grid, built in memory, batch 2): the
     kernel's launch count must be 3 per batch and the backward's 0,
     every metric finite and in range, the head outputs of the right
     shapes, and one eval batch's outputs must match a CPU run of the same
     weights (vocc.py widths on the 0.2 m occupancy grid: the CPU takes
     minutes for the full grid);
  7. train as ``python -m vln_ver_tpu_torch.train`` does
     (configs/verformer/vocc.py at full width, the same random weights
     from seed 0, phase 6's viewpoints with ground truth, batch
     samples_per_gpu = 1, the auction matcher): 6 steps through
     ``make_train_step``.  Each step must launch the forward and the
     backward kernel 3 times each, give every loss finite with the full
     key set and a finite gradient norm, and move the parameters; one step
     on the card must match a CPU step of the same weights and batch (0.2
     m grid, dropout off, host matcher): the same matched queries, the
     losses and every parameter's gradient.  Then one step with
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
     replay.py); an ``agent`` JSON line;
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
     agent/replay.py), then 4 updates, every loss finite and the
     parameters moved; then the handoff: save_model, load_model into a
     new policy (the weights equal) and evaluate_batched at batch 8 over
     the 16 episodes, every metric finite and in range; an
     ``agent_train`` JSON line;
  10. serve as ``python -m vln_ver_tpu_torch.serve`` does, in this
     process (``serve.serve``): configs/verformer/get_occ.py, phase 4's
     seed-0 model, ``--images`` with phase 4d's seed-1 ViT-B/16, batch_max
     8, a queue of 12 feature requests (phase 4's viewpoints), 4 image
     requests (4d's views) and 1 malformed one.  Every volume exactly
     equal to a direct make_bev_only call on the same padded batch on the
     card and within 1e-5 of phases 4 and 4d's, an error file for the
     malformed request, 3 forward launches a served batch and no
     backward; then ``--occupancy`` at vocc.py width on 2 of phase 6's
     viewpoints at batch_max 2, the labels and volumes equal to a direct
     forward and decode_occupancy;
  10b. one NCCL process group of world 1 (``parallel.multihost``, a local
     address and a free port), the lift on a view shard of the world
     group (index 0 of 1, so the view all-reduces run):
     ``dump_volumes(mesh=make_mesh((1, 1)))`` over phase 4's viewpoints
     (the benchmark's in-memory stand-in for h5py, ``verbench.h5mem``)
     with the dense lift, the volumes equal to phase 4's, and the sparse
     lift (capacity 256), within 1e-5 and no overflow; one ``train --mesh
     1`` step at vocc.py width (weights broadcast from rank 0, the
     gradients all-reduced) against the plain step under
     cudnn.deterministic (phase 7's card_step / hold_step: the matched
     queries, the losses and every gradient); ``evaluate_model(mesh=)``
     over phase 6's viewpoints equal to the one-process eval;
     ``episode_metrics`` and ``evaluate_batched`` with the mesh over phase
     8's 16 episodes equal to the one-process run's; the group destroyed;
  10c. a second NCCL group of world 1: one ``train --tp-model`` step
     (``make_tp_mesh(1, 1, 1)``, the state ``shard_state``-ed at the
     default min_size, its parameters all-gathered for the step and cut
     for AdamW) and one ``train --mesh 1,1,1`` step
     (``make_multislice_mesh``: the two-level gradient average) at vocc.py
     width, each against the plain step as 10b holds its own (1e-6);
     ``tp_fraction``, the bytes at rest of the sharded and the replicated
     state and the rule's bytes a rank at model 1 / 2 / 4 / 8;
     ``pipeline_apply`` at stage 1 with 2 and 4 microbatches over 4 encoder
     layers at get_occ.py width (batch 4 of phase 6's viewpoints, 900
     queries, 6 cameras of 14 x 14, 8 points) against ``sequential_apply``:
     outputs within 2e-5, gradients of sum(out**2) within rtol 5e-4 / atol
     5e-5, 4 x M forward and 4 x M backward launches;
  11. the temporal VER model (get_occ.py / vocc.py widths with
     use_temporal_self_attn, seed 0): ``obtain_history_bev`` over 3
     frames of 4 viewpoints walking straight lines, then the current
     frame's only_bev forward with prev_bev and the derived tsa_shift, 3
     launches a frame, held against the CPU on 2 of the viewpoints; the
     full forward with decoder_on_bev (mlp, then pool) at batch 2 on that
     history, held against the CPU on the 0.2 m grid: its first forward
     captures the decoder's CUDA graph (3 + 6 + 6 host launches, the last
     at the decoder's 900 queries), its second replays it (3 host
     launches, one ``decoder#graph_replays``); one TSA + decoder_on_bev
     (mlp) train step held against a CPU step as phase 7 holds its own
     (9 + 9 launches, every TSA parameter with a gradient);
  12. BEVFormer-2D at BEV2DConfig's defaults (seed 2) over synthetic
     nuScenes scenes of 3 frames (a 3-degree yaw change a frame, so
     rotate_prev_bev turns the previous grid) read through NuScenesAdapter
     (the info pkl under TMPDIR, the features in ``verbench.h5mem``'s
     stand-in for h5py) and collated on the host: each frame's full
     forward with the previous frame's bev_embed at batch 1 and 4, 12
     launches a frame, against the CPU; one backward of a scalar of the
     last frame's outputs at batch 1 (history frames without gradients,
     12 backward launches), card gradients against the CPU's; then the
     gather kernel (csrc/msda_gather.cu) at BEVFormer-base's three launch
     shapes (GATHER_SHAPES: the 4-level lift over 6 cameras, the TSA and
     the decoder over the 200 x 200 BEV; fp32, and bf16 at the lift's),
     one launch each and none of the staged kernel, against the plain
     version, timed beside its bound and the plain version's time;
  13. the 36-view headline model of ``python -m vln_ver_tpu_torch.bench``
     (VERConfig(num_cams=36, dtype=bfloat16), seed-0 weights, the example
     inputs of numpy seed 0): the capacity derived from the rig (192);
     one forward at batch 8 of the sparse and of the dense lift, 3
     forward launches each (nq 192 and 900) and no backward, 2 launches
     of the occupancy MLP kernel and 3 of the upsampler's assembly kernel
     (one a stage) each, sca_overflow 0; the same
     weights in fp32 at batch 8: the sparse lift's bev_embed within 1e-5
     of the dense lift's; one fp32 only_bev forward at batch 1 against
     the CPU (rtol 1e-4, atol 1e-4).  Then ``check_determinism`` at its
     defaults (36 cameras, bf16, batch 2, 3 runs: 3 forward, 2 occupancy
     MLP and 3 upsampler assembly launches a run, the differing outputs
     reported, not failed on).  Then, untimed: one bf16 train step at
     batch 2 (3 forward and 3 backward launches, no occupancy MLP or
     upsampler assembly launch: autograd on, a finite loss), and 16
     viewpoints of uint8 views through a bf16 ViT-B/16 and
     the sparse lift, ``dump_volumes`` into ``verbench.h5mem`` at batch 8
     (6 forward launches, nothing else, no overflow, every volume
     finite).  Then the ``kernels`` line (each kernel's times alone,
     bounds and errors) and the script's total time.
The last line is the ``{"ok": true, "device": ...}`` JSON object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

from verbench.flops import (HBM_BYTES_PER_S, PEAK_FLOP_PER_S, deform_bytes,
                            deform_least_s, upsampler_flop)
from verbench.h5mem import MemoryH5

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

# H100 SXM peaks (the benchmark's, verbench/flops.py): fp32 outside the
# tensor cores, bf16 on them
FP32_FLOP_PER_S = PEAK_FLOP_PER_S["float32"]
BF16_FLOP_PER_S = PEAK_FLOP_PER_S["bfloat16"]
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
TRAIN_STEPS = 6
# phase 8: the synthetic VLN environment, the policy's vocabulary and text
# length (tools/test_vln.py's R2R model), the lockstep eval batch
AGENT_SCANS, AGENT_NODES, AGENT_EPISODES = 3, 9, 16
AGENT_VOCAB, AGENT_TEXT_LEN, AGENT_BATCH = 4000, 80, 8
# phase 9: the agent's training on phase 8's environment and volumes; the
# JAX CLIs' defaults (pretrain batch 16 at lr 5e-5; DAgger with student
# actions half the time at lr 1e-4), lockstep rollouts of 8 episodes,
# updates of 8 decision steps
PRETRAIN_BATCH, PRETRAIN_LR = 16, 5e-5
DAGGER_SAMPLE_PROB, DAGGER_EPISODE_BATCH, DAGGER_UPDATE_BATCH = 0.5, 8, 8
DAGGER_LR = 1e-4
AGENT_TRAIN_UPDATES = 4
# phase 10: the server (the JAX tool's default batch_max) on phase 4's
# viewpoints and 4d's views; its --occupancy run at vocc.py width
SERVE_BATCH, SERVE_FEATURE_REQUESTS, SERVE_IMAGE_REQUESTS = 8, 12, 4
SERVE_OCC_BATCH = 2
# phase 11: the temporal model's history (frames before the current one)
# and batch; its CPU hold runs the first TEMPORAL_CPU_ROWS viewpoints (each
# viewpoint's computation is its own)
TEMPORAL_FRAMES, TEMPORAL_BATCH, TEMPORAL_CPU_ROWS = 3, 4, 2
# phase 12: BEVFormer-2D over synthetic nuScenes scenes of 3 frames, a yaw
# change of this many degrees a frame (so rotate_prev_bev turns the grid)
BEV2D_FRAMES, BEV2D_BATCHES, BEV2D_YAW_DEG = 3, (1, 4), 3.0
# phase 12: the gather kernel (csrc/msda_gather.cu) at BEVFormer-base's
# launches, (name, bs, level shapes, d, nq, P): the 4-level lift over 6
# cameras at the rig's capacity, the TSA over the 200 x 200 BEV's two
# queue slots, the decoder's 900 queries over it
GATHER_SHAPES = [
    ("BEVFormer-base SCA", 6, ((116, 200), (58, 100), (29, 50), (15, 25)),
     32, 12608, 8),
    ("BEVFormer-base TSA", 2, ((200, 200),), 32, 40000, 4),
    ("BEVFormer-base decoder", 1, ((200, 200),), 32, 900, 4),
]
# phases 3 and 5: the launches of phases 11 and 12 at full width:
# (name, bs, H, W, d, nq, P); the temporal model's SCA has the main shape
PATH_SHAPES = [
    ("decoder_on_bev B=2", 2, 15, 15, 96, 100, 4),
    ("bev2d SCA B=1", 6, 14, 14, 32, 225, 8),
    ("bev2d TSA-2D B=1", 2, 15, 15, 32, 225, 4),
    ("bev2d decoder B=1", 1, 15, 15, 32, 100, 4),
    ("bev2d SCA B=4", 24, 14, 14, 32, 225, 8),
    ("bev2d TSA-2D B=4", 8, 15, 15, 32, 225, 4),
    ("bev2d decoder B=4", 4, 15, 15, 32, 100, 4),
]
# phase 13: the 36-view headline (vln_ver_tpu_torch.bench) at batch 8; the
# sparse lift's capacity the rig gives
HEADLINE_CAMS, HEADLINE_BATCH, HEADLINE_QCAP = 36, 8, 192
# phases 3 and 5: its launches, (name, bs, nq, backward too): the forward
# at batch 8, both kernels at the 36-view training batch 2, each over the
# dense lift's 900 queries and the sparse lift's 192; the plain version
# runs over blocks of this many slots (its gather of fp32 samples is 6.4
# GB at 288 slots, before the taps)
HEADLINE_SHAPES = [
    ("36-view B=8 nq=900", 288, 900, False),
    ("36-view B=8 nq=192", 288, HEADLINE_QCAP, False),
    ("36-view B=2 nq=900", 72, 900, True),
    ("36-view B=2 nq=192", 72, HEADLINE_QCAP, True),
]
PLAIN_SLOTS = 72
# phase 5c: the occupancy MLP kernel at the headline's even grid, (batch,
# h2, w2, occ_z, occ_dims, occupancy_classes) at batch 1 and 8
OCC_MLP_SHAPES = [(1, 60, 60, 35, 128, 16), (8, 60, 60, 35, 128, 16)]
# phase 5b: the upsampler at the headline's batch and the eval batch; its
# bf16 holds against the dense route in relative L2 (several bf16
# roundings of the tap and phase sums against one)
UPSAMPLER_BATCHES = (8, 2)
# phase 5d: the upsampler's assembly kernel at the headline's batch and
# batch 1
UP_ASSEMBLE_BATCHES = (1, 8)
UPSAMPLER_BF16_REL = 2e-2


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


def deform_bound(value, loc, spatial_hw, backward=False):
    """(least ms, what bounds it) of one launch on these inputs, as the
    benchmark counts it (``verbench.flops.deform_least_s``): the bytes it
    must move over the HBM rate against its fp32 multiply-adds, one a
    channel for each tap that lands inside the map (two in the backward,
    which also writes the inputs' gradients), counted on this data."""
    import types
    bs, hw, heads, d = value.shape
    launch = types.SimpleNamespace(
        dtype=str(value.dtype).split(".")[-1], num_cams=bs, feat_h=hw,
        feat_w=1, embed_dims=heads * d, num_heads=heads, head_dim=d,
        lift_queries=loc.shape[1], sca_num_points=loc.shape[4])
    least = deform_least_s(launch, 1, valid_taps(loc, spatial_hw), backward)
    by_bytes = deform_bytes(launch, 1, backward) / HBM_BYTES_PER_S >= least
    return least * 1e3, "bytes" if by_bytes else "operations"


def plain_forward(value, spatial_hw, loc, weights, block=PLAIN_SLOTS):
    """The plain version in fp32, over blocks of ``block`` slots (each
    slot's output depends on its own inputs alone)."""
    import torch

    from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d
    return torch.cat([ms_deform_attn_2d(
        value[i:i + block].float(), (spatial_hw,), loc[i:i + block],
        weights[i:i + block]) for i in range(0, value.shape[0], block)])


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


@contextlib.contextmanager
def planned(every=False):
    """Inside the block, the query count of the latest launch of the
    forward and of the backward deformable-attention kernel, as each
    kernel plans it: yields {"fwd": nq, "bwd": nq}, None until one
    launches; with ``every``, the list of every launch's.  A CUDA graph's
    replay plans nothing."""
    from unittest import mock

    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    last = {"fwd": [], "bwd": []} if every else {"fwd": None, "bwd": None}

    def watched(key, plan):
        def call(bs, heads, nq, *rest):
            if every:
                last[key].append(nq)
            else:
                last[key] = nq
            return plan(bs, heads, nq, *rest)
        return call

    with mock.patch.object(KERNEL, "plan", watched("fwd", KERNEL.plan)), \
            mock.patch.object(KERNEL_BWD, "plan",
                              watched("bwd", KERNEL_BWD.plan)):
        yield last


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


def rel_l2(got, ref):
    """||got - ref|| / ||ref||, in float64."""
    ref = ref.detach().double()
    return float((got.detach().double() - ref).norm()
                 / ref.norm().clamp_min(1e-300))


def stage1_weight_grad_errors(gen):
    """Relative L2 error, against a float64 run, of the fp32 weight
    gradient of stage 1's middle z-tap (the 5 x 5 correlation on the 15 x
    15 grid, 768 channels, 8 planes: batch 2 of vocc.py's grid) in the two
    forms ``head._zslab`` could take: depth-1 3D convolutions (the one it
    takes) and 2D convolutions over (planes, C, H, W)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    x = torch.randn(1, 8, 15, 15, 768, device=dev, generator=gen)
    k = torch.randn(768, 768, 5, 5, device=dev, generator=gen) / 1920 ** 0.5
    g = torch.randn(1, 8, 15, 15, 768, device=dev, generator=gen)
    forms = {
        "3d": lambda x, k: F.conv3d(x.permute(0, 4, 1, 2, 3), k[:, :, None],
                                    padding=(0, 2, 2)).permute(0, 2, 3, 4, 1),
        "2d": lambda x, k: F.conv2d(x[0].permute(0, 3, 1, 2), k,
                                    padding=2).permute(0, 2, 3, 1)[None]}
    kd = k.double().requires_grad_()
    ref = torch.autograd.grad(forms["3d"](x.double(), kd), kd, g.double())[0]
    errs = {}
    for name, form in forms.items():
        kf = k.clone().requires_grad_()
        errs[name] = rel_l2(torch.autograd.grad(form(x, kf), kf, g)[0], ref)
    return errs


def upsampler_routes(card):
    """Phase 5b: ``OccUpsampler`` against its dense plain reference at
    vocc.py width; returns the ``upsampler`` JSON line's numbers."""
    import torch

    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.models.head import (OccUpsampler,
                                               dense_reference,
                                               upsampler_stages)
    from vln_ver_tpu_torch.ops.up_assemble import KERNEL as UP_KERNEL
    from vln_ver_tpu_torch.runtime import fp32_precision

    dev = torch.device("cuda")
    ver = build_ver_config(load_config(
        os.path.join(REPO, "configs/verformer/vocc.py")))
    c, z, h, w = ver.embed_dims, ver.bev_z, ver.bev_h, ver.bev_w
    n = upsampler_stages(ver)
    flop = dict(zip(("factorised", "dense"), upsampler_flop(c, z, h, w, n)))
    numbers = {f"gflop_{k}": v / 1e9 for k, v in flop.items()}
    print(f"upsampler at vocc.py width: {c} channels, ({z}, {h}, {w}) -> "
          f"({z}, {ver.occ_ydim}, {ver.occ_xdim}) in {n} stages; "
          f"{flop['factorised'] / 1e9:.1f} GFLOP a viewpoint factorised, "
          f"{flop['dense'] / 1e9:.1f} dense")
    gen = torch.Generator().manual_seed(0)
    cuda_gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, peak in ((torch.float32, FP32_FLOP_PER_S),
                        (torch.bfloat16, BF16_FLOP_PER_S)):
        name = "fp32" if dtype == torch.float32 else "bf16"
        up = OccUpsampler(c, n, dtype)
        with torch.no_grad():
            for stage in up:
                stage.reset_parameters(gen)
                stage.bias.normal_(0.0, 0.1, generator=gen)
        up.to(dev)
        dense = dense_reference(up)
        params = [p for stage in up for p in (stage.weight, stage.bias)]
        grad_names = ["input"] + [f"{i}.{p}" for i in range(n)
                                  for p in ("weight", "bias")]

        def routes(x):
            """The factorised full output and (e + bias), the dense
            output and its even cells, all NDHWC."""
            e, bias = up.informative(x)
            ref = dense(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
            return up(x), e + bias, ref, ref[:, :, ::2, ::2]

        for b in UPSAMPLER_BATCHES:
            x = torch.randn(b, z, h, w, c, device=dev, generator=cuda_gen)
            x.requires_grad_()
            with fp32_precision(dtype):
                full, even, ref, ref_even = routes(x)
                g = torch.randn(full.shape, device=dev, generator=cuda_gen,
                                dtype=full.dtype)
                g_even = g[:, :, ::2, ::2]
                errs = {}
                for what, got, want in (("full", full, ref),
                                        ("informative", even, ref_even)):
                    errs[what] = rel_l2(got, want)
                    if dtype == torch.float32:
                        errs[what + " max_abs"], ok = close(got, want, 1e-4,
                                                            1e-4)
                    else:
                        ok = errs[what] <= UPSAMPLER_BF16_REL
                    if not ok:
                        fail(f"upsampler {name} B={b}: the factorised "
                             f"{what} output disagrees with the dense "
                             f"reference ({errs})")
                with torch.no_grad():   # the z-major route: autograd off
                    before = UP_KERNEL.launches
                    e_k, bias_k = up.informative(x.detach())
                    launches = UP_KERNEL.launches - before
                    got = e_k + bias_k
                errs["z-major"] = rel_l2(got, ref_even)
                if dtype == torch.float32:
                    errs["z-major max_abs"], ok = close(got, ref_even, 1e-4,
                                                        1e-4)
                else:
                    ok = errs["z-major"] <= UPSAMPLER_BF16_REL
                if not ok or launches != n:
                    fail(f"upsampler {name} B={b}: the z-major route's even "
                         f"grid ({launches} assembly launches) disagrees "
                         f"with the dense reference ({errs})")
                del e_k, got
                for what, out, out_ref, cot in (
                        ("full", full, ref, g),
                        ("informative", even, ref_even, g_even)):
                    got = torch.autograd.grad(out, [x, *params], cot,
                                              retain_graph=True)
                    want = torch.autograd.grad(out_ref, [x, *params], cot,
                                               retain_graph=True)
                    grad_errs = dict(zip(grad_names, (
                        rel_l2(a, r) for a, r in zip(got, want))))
                    worst = max(grad_errs, key=grad_errs.get)
                    errs[what + " grads"] = grad_errs[worst]
                    limit = (1e-4 if dtype == torch.float32
                             else UPSAMPLER_BF16_REL)
                    if grad_errs[worst] > limit:
                        fail(f"upsampler {name} B={b}: the factorised "
                             f"{what} route's gradients disagree with the "
                             f"dense reference's, worst {worst} (limit "
                             f"{limit}; relative L2: {grad_errs})")
                del full, even, ref, ref_even
                if b == UPSAMPLER_BATCHES[-1]:
                    saved = torch.backends.cudnn.deterministic
                    torch.backends.cudnn.deterministic = True
                    try:
                        runs = [torch.autograd.grad(up(x), [x, *params], g)
                                for _ in range(2)]
                    finally:
                        torch.backends.cudnn.deterministic = saved
                    if not all(torch.equal(a, r) for a, r in zip(*runs)):
                        fail(f"upsampler {name} B={b}: two backward runs "
                             "under cudnn.deterministic differ")
                    del runs
                with torch.no_grad():
                    xd = x.detach()
                    xn = xd.permute(0, 4, 1, 2, 3)
                    t = {"factorised_informative": time_ms(
                        lambda: up.informative(xd), iters=3, warmup=1),
                         "factorised_full": time_ms(lambda: up(xd), iters=3,
                                                    warmup=1),
                         "dense": time_ms(lambda: dense(xn), iters=3,
                                          warmup=1)}
                t["factorised_train"] = time_ms(lambda: torch.autograd.grad(
                    up(x), [x, *params], g), iters=2, warmup=1)
                t["dense_train"] = time_ms(lambda: torch.autograd.grad(
                    dense(x.permute(0, 4, 1, 2, 3)), [x, *params],
                    g.permute(0, 4, 1, 2, 3)), iters=2, warmup=1)
            share = {k: b * flop["dense" if k.startswith("dense")
                                 else "factorised"]
                     * (3 if k.endswith("train") else 1) / (v / 1e3) / peak
                     for k, v in t.items()}
            numbers[f"{name}_b{b}"] = {"ms": t, "peak_share": share,
                                       "errors": errs}
            print(f"upsampler {name} B={b}: factorised vs dense "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + " ok; device ms (CUDA events): " + ", ".join(
                      f"{k} {v:.3f} ({100 * share[k]:.1f}% of the {name} "
                      "peak)" for k, v in t.items())
                  + f"; dense / factorised forward "
                  f"{t['dense'] / t['factorised_full']:.2f}x [{card}]")
            del x, g, g_even
        del up, dense, params
    with fp32_precision(torch.float32):
        wgrad = stage1_weight_grad_errors(cuda_gen)
    numbers["stage1_weight_grad_rel_l2"] = wgrad
    print(f"stage-1 weight gradient in fp32 against float64 (relative L2): "
          f"depth-1 3D convolutions {wgrad['3d']:.3e} (the route's), 2D "
          f"convolutions {wgrad['2d']:.3e} [{card}]")
    if wgrad["3d"] > 1e-5:
        fail(f"the upsampler's stage-1 weight gradient is {wgrad['3d']:.3e} "
             "off a float64 run in relative L2 (limit 1e-5)")
    torch.cuda.empty_cache()
    return numbers


def branch_float64(branch, x):
    """A two-hidden-layer ``ClsBranch``'s function in float64 with no
    rounding: the yardstick of the rounding error of both the occupancy MLP
    kernel and the eager chain (phase 5c and ``tests/test_torch_occ_mlp.py``).
    """
    import torch
    with torch.no_grad():
        h = x.double()
        for i in (0, 3):
            ln = branch[i + 1]
            h = torch.nn.functional.layer_norm(
                h @ branch[i].weight.double().t() + branch[i].bias.double(),
                h.shape[-1:], ln.weight.double(), ln.bias.double(),
                ln.eps).clamp_min(0)
        return h @ branch[-1].weight.double().t() + branch[-1].bias.double()


def occ_mlp_bound_ms(b, h2, w2, oz, d, n):
    """Least time of the occupancy MLP and its lattice: the bf16 rows read
    once and the fp32 lattice written once, or the two bf16 products at the
    tensor-core peak, or the fp32 last layer at the fp32 peak, whichever is
    longest."""
    rows = b * h2 * w2 * oz
    moved = rows * d * 2 + b * oz * 4 * h2 * w2 * n * 4
    return 1e3 * max(moved / HBM_BYTES_PER_S,
                     4.0 * rows * d * d / BF16_FLOP_PER_S,
                     2.0 * rows * d * n / FP32_FLOP_PER_S)


def occ_mlp_shapes(card):
    """Phase 5c: the occupancy MLP kernel against the eager chain at the
    headline's even grid; returns the ``occ_mlp`` JSON line's numbers."""
    import torch

    from vln_ver_tpu_torch.models.head import ClsBranch
    from vln_ver_tpu_torch.ops.occ_mlp import (KERNEL, lattice_plain,
                                               occ_mlp_lattice, occ_mlp_rows)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    numbers = {}
    for b, h2, w2, oz, d, n in OCC_MLP_SHAPES:
        gen = torch.Generator().manual_seed(9)
        branch = ClsBranch(d, n, 2, bf16)
        with torch.no_grad():
            for m in branch:
                for t in m.parameters():
                    t.copy_(torch.randn(t.shape, generator=gen)
                            / (t.shape[-1] ** 0.5 if t.dim() == 2 else 5.0))
            for i in (1, 4):
                branch[i].weight.add_(1.0)
        branch = branch.to(dev).eval()
        x = (0.7 * torch.randn(b, h2, w2, oz, d, generator=gen)).to(dev, bf16)
        bias_rows = (0.7 * torch.randn(oz, d, generator=gen)).to(dev, bf16)
        with torch.inference_mode():
            before = KERNEL.launches
            bias_logits = occ_mlp_rows(bias_rows, branch)
            got = occ_mlp_lattice(x, branch, bias_logits)
            torch.cuda.synchronize()
            launches = KERNEL.launches - before
            odd_equal = all(torch.equal(
                got[:, :, dy::2, dx::2],
                bias_logits[None, :, None, None].expand(b, oz, h2, w2, n))
                for dy, dx in ((0, 1), (1, 0), (1, 1)))
            # the eager chain: the branch module on the bias rows, and the
            # plain lattice from its bias logits
            bias_plain = branch(bias_rows)
            rows_err = float((bias_logits - bias_plain).abs().max())
            want = lattice_plain(x, branch, bias_plain)
            err = float((got - want).abs().max())
            del want
            # the eager chain's own error, a batch at a time
            eager_err = max(float((branch(x[i]).double() - branch_float64(
                branch, x[i])).abs().max()) for i in range(b))
            ms = time_ms(lambda: occ_mlp_lattice(x, branch, bias_logits),
                         iters=50, warmup=5)
            eager_ms = time_ms(lambda: lattice_plain(x, branch, bias_logits),
                               iters=10, warmup=2)
        bound = occ_mlp_bound_ms(b, h2, w2, oz, d, n)
        tag = f"B={b}"
        numbers[tag] = {"ms": ms, "bound_ms": bound,
                        "share": 100.0 * bound / ms, "eager_ms": eager_ms,
                        "max_abs_err": err, "rows_max_abs_err": rows_err,
                        "eager_max_abs_err": eager_err,
                        "launches": launches}
        print(f"occupancy MLP kernel {tag} ({b * h2 * w2 * oz} rows of {d}, "
              f"n={n}): {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100.0 * bound / ms:.1f} %), eager chain {eager_ms:.4f} ms "
              f"({eager_ms / ms:.1f}x); max_abs_err {err:.3e} (lattice), "
              f"{rows_err:.3e} (bias cell's rows) against the eager chain, "
              f"whose own against float64 is {eager_err:.3e}; odd cells the "
              f"bias logits bit for bit {odd_equal}; {launches} launches a "
              f"call [{card}]")
        if (launches != 2 or not odd_equal or err > eager_err
                or rows_err > eager_err):
            fail(f"occupancy MLP kernel {tag}: launches {launches}, odd cells "
                 f"equal {odd_equal}, max_abs_err {err:.3e} (lattice) and "
                 f"{rows_err:.3e} (rows) against the eager chain (limit "
                 f"{eager_err:.3e})")
        del x, got, branch, bias_plain
        torch.cuda.empty_cache()
    return numbers


def up_assemble_bound_ms(z, b, ho, wo, c, itemsize, prof):
    """Least time of one assembly: every tap value that feeds an even cell
    (the k = 1 tap at each plane, the k = 0 tap at planes >= 2, the k = 2
    tap at planes <= Z - 3) and every profile value read once, the even
    grid written once."""
    feeds = sum(1 + (zi >= 2) + (zi <= z - 3) for zi in range(z))
    cells = ho * wo * c * itemsize
    moved = (feeds * b + (1 + 2 * (z > 2)) * prof + z * b) * cells
    return 1e3 * moved / HBM_BYTES_PER_S


def up_assemble_stages(up, x, each=None):
    """The stages of ``up`` on the z-major route on the card, from x
    (B, Z, H, W, C): each stage's taps from its own convolutions, its even
    grid by the kernel and by the plain assembly, and the kernel's grid
    fed to the next stage.  Returns, a stage, the kernel's launches,
    whether its grid is the plain one's bit for bit, its shape and dtype,
    and what ``each(phases, prof, grid)`` returns (phase 5d's times)."""
    import torch

    from vln_ver_tpu_torch.ops.up_assemble import (KERNEL, assemble,
                                                   assemble_plain)
    out = []
    with torch.inference_mode():
        e = x.to(up[0].dtype).transpose(0, 1).contiguous()
        for i, stage in enumerate(up):
            phases, prof, grid = (stage.even_taps(e) if i == 0 else
                                  stage.phase_taps(e, up[i - 1].bias))
            before = KERNEL.launches
            got = assemble(phases, prof, grid)
            torch.cuda.synchronize()
            launches = KERNEL.launches - before
            want = assemble_plain(phases, prof, grid)
            out.append({"launches": launches,
                        "equal": torch.equal(got, want),
                        "shape": tuple(got.shape), "dtype": got.dtype,
                        "prof": prof is not None,
                        **(each(phases, prof, grid) if each else {})})
            e = got
            del phases, prof, want
    return out


def up_assemble_shapes(card):
    """Phase 5d: the upsampler's assembly kernel against the plain assembly
    at the headline's widths (``up_assemble_stages``); returns the
    ``up_assemble`` JSON line's numbers."""
    import torch

    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.models.head import OccUpsampler, upsampler_stages
    from vln_ver_tpu_torch.ops.up_assemble import assemble, assemble_plain
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    ver = build_ver_config(load_config(
        os.path.join(REPO, "configs/verformer/vocc.py")))
    c, z, h, w = ver.embed_dims, ver.bev_z, ver.bev_h, ver.bev_w
    gen = torch.Generator().manual_seed(11)
    up = OccUpsampler(c, upsampler_stages(ver), bf16)
    with torch.no_grad():
        for stage in up:
            stage.reset_parameters(gen)
            stage.bias.normal_(0.0, 0.1, generator=gen)
    up.to(dev)

    def timed(phases, prof, grid):
        return {"ms": time_graph_ms(lambda: assemble(phases, prof, grid)),
                "eager_ms": time_ms(lambda: assemble(phases, prof, grid),
                                    iters=50, warmup=5),
                "plain_ms": time_ms(
                    lambda: assemble_plain(phases, prof, grid), iters=5,
                    warmup=1)}

    numbers = {}
    for b in UP_ASSEMBLE_BATCHES:
        x = torch.randn(b, z, h, w, c, generator=gen).to(dev, bf16)
        stages = up_assemble_stages(up, x, timed)
        for i, st in enumerate(stages):
            if st["launches"] != 1 or not st["equal"]:
                fail(f"up_assemble B={b} stage {i}: launches "
                     f"{st['launches']}, equal to the plain assembly "
                     f"{st['equal']}")
            _, _, ho, wo, _ = st["shape"]
            st.update(grid=[ho, wo], bound_ms=up_assemble_bound_ms(
                z, b, ho, wo, c, 2, st["prof"]))
            for k in ("launches", "equal", "shape", "dtype", "prof"):
                del st[k]
        total = {k: sum(s[k] for s in stages)
                 for k in ("ms", "eager_ms", "bound_ms", "plain_ms")}
        tag = f"B={b}"
        numbers[tag] = {**total, "share": 100.0 * total["bound_ms"]
                        / total["ms"], "stages": stages}
        print(f"upsampler assembly kernel {tag} (bf16, {c} channels, Z = "
              f"{z}, {len(up)} stages): {total['ms']:.4f} ms (graph; eager "
              f"{total['eager_ms']:.4f}), bound {total['bound_ms']:.4f} ms "
              f"({numbers[tag]['share']:.1f} %), plain assembly "
              f"{total['plain_ms']:.4f} ms; by stage (graph / bound / plain) "
              + ", ".join(f"{s['grid'][0]}x{s['grid'][1]} {s['ms']:.4f} / "
                          f"{s['bound_ms']:.4f} / {s['plain_ms']:.4f}"
                          for s in stages)
              + f"; bit for bit the plain assembly, a launch a stage "
              f"[{card}]")
        del x
        torch.cuda.empty_cache()
    return numbers


def full_forward_and_eval(model, ver):
    """Phase 6; returns the synthetic viewpoints."""
    import torch

    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.data import synthetic_samples
    from vln_ver_tpu_torch.evaluation.runner import evaluate_model
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

    KERNEL.launches = KERNEL_BWD.launches = 0
    metrics = evaluate_model(model, samples, occ_thresholds=(0.25,),
                             batch_size=EVAL_BATCH, classes=classes)
    launches, bwd_launches = KERNEL.launches, KERNEL_BWD.launches
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
    print(f"eval: {n} viewpoints at batch {EVAL_BATCH} (features on the "
          f"host -> metrics), deform launches {launches}")

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
    return samples


def training(ver, samples, card):
    """Phase 7."""
    import torch

    from vln_ver_tpu_torch.config import build_train_config, load_config
    from vln_ver_tpu_torch.data.mp3d import collate
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.train import (create_train_state, make_train_step,
                                         staged_batches, to_device)

    dev = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs/verformer/vocc.py"))
    batch = int(cfg["data"]["samples_per_gpu"])
    tc = build_train_config(cfg, len(samples) // batch)
    model = build_model(ver, dev, seed=0)
    state = create_train_state(model, tc)
    step_fn = make_train_step(ver, tc)
    batches = [collate(samples[i:i + batch])
               for i in range(0, len(samples) - batch + 1, batch)]
    batches = (batches * -(-TRAIN_STEPS // len(batches)))[:TRAIN_STEPS]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    KERNEL.launches = KERNEL_BWD.launches = 0
    metrics = [step_fn(state, b, seed=1) for b in staged_batches(
        batches, lambda b: to_device(b, dev))]
    fwd, bwd = KERNEL.launches, KERNEL_BWD.launches
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
    print(f"train: {TRAIN_STEPS} steps at batch {batch} ({tc.matcher} "
          f"matcher), {moved} of {len(after)} parameters moved, deform "
          f"launches {fwd} forward + {bwd} backward")

    # one step on the card against one on the CPU: the same weights and
    # batch, dropout off, the exact host matcher, on the 0.2 m grid (the
    # CPU's full-grid upsampler takes minutes)
    check = dataclasses.replace(ver, occupancy_size=(0.2, 0.2, 0.2),
                                dropout_rate=0.0)
    step_card_vs_cpu(check, tc, "vocc.py widths", card)
    remat_and_capacity(ver, tc, batches[0], card)


def off_lattice(model, seed=5):
    """Move every temporal self-attention's sampling offsets off the
    lattice, in place: uniform(-0.25, 0.25) added to the offsets' bias,
    drawn on the CPU from ``seed``.  At init the offsets' kernel is zero
    and the bias a directional grid of whole steps, and the TSA's
    reference points are cell centres, so every sample lands on a
    lattice point, where bilinear and trilinear interpolation have no
    derivative (the left and right ones differ by a whole tap's value)
    and two devices' rounding picks either side; a trained model's
    offsets are off the lattice.  Returns the model."""
    import torch

    from vln_ver_tpu_torch.models.bev2d import TemporalSelfAttention2D
    from vln_ver_tpu_torch.models.temporal import VoxelTemporalSelfAttention
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (VoxelTemporalSelfAttention,
                              TemporalSelfAttention2D)):
                b = m.sampling_offsets.bias
                b += (torch.rand(b.shape, generator=gen) * 0.5 - 0.25).to(
                    b.device)
    return model


def step_card_vs_cpu(check, tc, what, card):
    """One ``make_train_step`` of ``check`` (dropout off) on the card
    against one on the CPU: the same seed-0 weights (a TSA's offsets
    moved off the lattice, :func:`off_lattice`) and synthetic batch of
    one viewpoint, the exact host matcher, the card's ReLUs on the CPU
    step's masks.  Fails unless the matched queries are equal, the losses
    within rtol 1e-4 and every gradient within 1e-3 of its L2 norm (plus
    1e-5 x sqrt(n)); returns (the card step's forward and backward kernel
    launches, the card's gradients by name)."""
    import torch

    from vln_ver_tpu_torch.data import synthetic_samples
    from vln_ver_tpu_torch.data.mp3d import collate
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.runtime import fp32_precision
    from vln_ver_tpu_torch.train import (create_train_state, make_train_step,
                                         to_device)
    from vln_ver_tpu_torch.train.objective import detection_matches
    from vln_ver_tpu_torch.utils.params import grads_by_name, relu_masks

    dev = torch.device("cuda")
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
        m = off_lattice(build_model(check, device, seed=0))
        bb = to_device(one, device)
        with torch.no_grad(), fp32_precision(check.dtype):
            outs = m.train()(bb["features"], bb["world2pixel"],
                             bb["origin_shift"])
            matched = detection_matches(outs["all_cls_scores"],
                                        outs["all_bbox_preds"], bb, "host")
        st = create_train_state(m, tc_host)
        cpu = device.type == "cpu"
        KERNEL.launches = KERNEL_BWD.launches = 0
        with relu_masks(m, record=masks if cpu else None,
                        pin=None if cpu else masks) as flips:
            mets = make_train_step(check, tc_host)(st, bb, seed=1)
        res[device.type] = (matched.cpu(),
                            {k: float(v) for k, v in mets.items()},
                            {n: g.cpu() for n, g in grads_by_name(m).items()},
                            time.perf_counter() - t0, flips[0],
                            (KERNEL.launches, KERNEL_BWD.launches))
    (mc, lc, gc, _, flips, launches), (mh, lh, gh, cpu_s, _, _) = (
        res["cuda"], res["cpu"])
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
    print(f"train step card vs CPU ({what}, occupancy grid {grid}, "
          f"host matcher): matched queries equal ({mc.numel()} GT slots), "
          f"largest relative loss difference {worst_loss[0]:.3e} "
          f"({worst_loss[1]}) (rtol 1e-4) "
          f"{'ok' if not bad else 'FAIL ' + str(bad)}; grad_norm card "
          f"{lc['grad_norm']:.6f}, CPU {lh['grad_norm']:.6f}")
    worst, failed = (0.0, None), []
    for n, g_cpu in gh.items():
        diff = float(torch.linalg.vector_norm((gc[n] - g_cpu).double()))
        ref = float(torch.linalg.vector_norm(g_cpu.double()))
        rel = diff / max(ref, 1e-30)
        if diff > 1e-3 * ref + 1e-5 * g_cpu.numel() ** 0.5:
            failed.append(n)
        if ref > 0 and rel > worst[0]:
            worst = (rel, n)
    print(f"train step gradients card vs CPU ({what}): {len(gh)} parameters, "
          f"worst relative L2 difference {worst[0]:.3e} ({worst[1]}) (within "
          f"1e-3 relative + 1e-5 x sqrt(n)) "
          f"{'ok' if not failed else 'FAIL ' + str(failed[:5])}; the CPU "
          f"step took {cpu_s:.2f}s; the card step's deform launches "
          f"{launches[0]} forward + {launches[1]} backward")
    if bad or failed:
        fail(f"card train losses {bad} or gradients {failed[:5]} disagree "
             f"with the CPU step")
    return launches, gc


def worst_relative(got, ref):
    """(largest relative difference, its key) over the losses: every
    metric but ``grad_norm`` and ``sca_overflow``."""
    return max((abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12), k)
               for k in ref if k not in ("grad_norm", "sca_overflow"))


def card_step(cfg, tc, host_batch, record=None, pin=None, mesh=None,
              views=None, weights=None, tp=False, keep=None):
    """One ``make_train_step`` on the card from the seed-0 weights: (the
    matched query of every GT slot of every match the step made, its
    metrics, every parameter's gradient, forward and backward launches and
    the nq of their last launches).  ``record`` / ``pin``: the ReLU masks
    (``utils.params.relu_masks``); ``mesh``: the step of ``train --mesh``
    (the weights broadcast from rank 0, the gradients all-reduced);
    ``views``: the lift's view shard (default: the mesh's); ``weights``:
    the seed-0 state_dict already drawn (else it is drawn here); ``tp``:
    the state sharded on ``mesh`` (``train --tp-model``); ``keep``: a list
    the train state is appended to."""
    from unittest import mock

    import torch

    from vln_ver_tpu_torch.models import VoxelFormer, build_model
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.train import (create_train_state, make_train_step,
                                         objective, to_device)
    from vln_ver_tpu_torch.utils.params import grads_by_name, relu_masks

    matches, inner = [], objective._match

    def match(*args, **kw):
        out = inner(*args, **kw)
        matches.append(out.cpu().flatten())
        return out

    if weights is None:
        model = build_model(cfg, "cuda", seed=0)
    else:
        model = VoxelFormer(cfg)
        model.load_state_dict(weights, strict=True)
        model = model.to("cuda").eval()
    if mesh is not None:
        from vln_ver_tpu_torch.parallel.mesh import replicate
        replicate(mesh, model).shard_views(
            mesh.views if views is None else views)
    state = create_train_state(model, tc)
    if tp:
        from vln_ver_tpu_torch.parallel.tensor import shard_state
        shard_state(mesh, state)
    if keep is not None:
        keep.append(state)
    batch = to_device(host_batch, torch.device("cuda"))
    KERNEL.launches = KERNEL_BWD.launches = 0
    with mock.patch.object(objective, "_match", match), \
            relu_masks(model, record=record, pin=pin), planned() as nq:
        metrics = make_train_step(cfg, tc, mesh)(state, batch, seed=1)
    torch.cuda.synchronize()
    return (torch.cat(matches), {k: float(v) for k, v in metrics.items()},
            {n: g.cpu() for n, g in grads_by_name(model).items()},
            (KERNEL.launches, KERNEL_BWD.launches), (nq["fwd"], nq["bwd"]))


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
    """Phase 7's remat and capacity steps.

    Every step here runs with cuDNN's deterministic algorithms: the
    upsampler's backward convolutions otherwise add in a varying order,
    which moved the upsampler's weight gradients by 1.255e-04 of their
    norm between two steps of identical forwards, more than the remat
    check's 1e-4."""
    import torch
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _remat_and_capacity(ver, tc, host_batch, card)
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


def drive(bev_only, host_batches, ver, device):
    """Upload each batch of host arrays, run ``bev_only`` on them and bring
    the volumes back in the dump layout: (volumes (N, C, Z, H, W), the
    largest sca_overflow)."""
    import torch

    from vln_ver_tpu_torch.ver_writer import volumes_from_bev
    vols, overflow = [], 0
    for arrays in host_batches:
        bev, ovf = bev_only(*(torch.from_numpy(a).to(device)
                              for a in arrays))
        overflow = max(overflow, int(ovf))
        vols.append(volumes_from_bev(bev.float().cpu().numpy(), ver))
    return np.concatenate(vols), overflow


def counted(bev_only, host_batches, ver):
    """``drive`` on the card with the kernels' counts set to 0 just before
    it; fails on a backward launch.  Returns (volumes, overflow, forward
    launches, nq of the last launch)."""
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    KERNEL.launches = KERNEL_BWD.launches = 0
    with planned() as nq:
        vols, ovf = drive(bev_only, host_batches, ver, "cuda")
    if KERNEL_BWD.launches:
        fail(f"an inference path launched the backward kernel "
             f"{KERNEL_BWD.launches} times")
    return vols, ovf, KERNEL.launches, nq["fwd"]


def batches_of(*arrays):
    return [tuple(a[b0:b0 + BATCH] for a in arrays)
            for b0 in range(0, N_VIEWPOINTS, BATCH)]


def sparse_lift(model, ver, feats, w2p, shift, dense_vols, card):
    """Phase 4b; returns its kernel times for the kernels line."""
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
    vols, ovf, launches, nq = counted(
        make_bev_only(sparse), batches_of(feats, w2p, shift), ver)
    del sparse
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
    print(f"sparse lift: {N_VIEWPOINTS} volumes at batch {BATCH}, deform "
          f"launches {launches} at nq={nq}")
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
                *deform_bound(v, loc, (ver.feat_h, ver.feat_w)))
    (ms_k, bound_k, by_k), (ms_d, _, _) = times[SPARSE_K], times[ver.bev_num]
    print(f"deform_attn_2d B={BATCH} fp32 at nq={SPARSE_K}: {ms_k:.4f} ms "
          f"(graph), bound {bound_k:.4f} ms ({by_k}), "
          f"{100 * bound_k / ms_k:.1f}% of bound; at nq={ver.bev_num}: "
          f"{ms_d:.4f} ms ({ms_d / ms_k:.2f}x) [{card}]")
    return dict(ms_b4_nq256=ms_k, ms_b4_nq900=ms_d,
                bound_ms_b4_nq256=bound_k)


def int8_upload(model, cpu_model, ver, feats, w2p, shift, dense_vols):
    """Phase 4c; returns the largest deviation of its volumes from the fp32
    upload's."""
    import torch

    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.ver_writer import dequantize_int8, quantize_int8

    batches = [(*quantize_int8(f), m, s)
               for f, m, s in batches_of(feats, w2p, shift)]

    def int8_path(bev_only):
        def run(q, scale, m, s):
            return bev_only(dequantize_int8(q, scale, ver.dtype), m, s)
        return run

    vols, ovf, launches, _ = counted(
        int8_path(make_bev_only(model)), batches, ver)
    if ovf or launches != ver.encoder_layers * len(batches):
        fail(f"int8 path: overflow {ovf}, {launches} launches")
    t0 = time.perf_counter()
    cpu_vols, _ = drive(int8_path(make_bev_only(cpu_model)), batches,
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
    print(f"int8 upload: {N_VIEWPOINTS} volumes at batch {BATCH}, deform "
          f"launches {launches}; largest deviation from the fp32 volumes "
          f"{dev_fp32:.3e} (of |v| <= {float(np.abs(dense_vols).max()):.3f})")
    return dev_fp32


def image_path(model, ver, w2p, shift):
    """Phase 4d; returns its images and volumes."""
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
    vols, ovf, launches, nq = counted(
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
    two, _ = drive(make_bev_only(model), batches_of(feats, w2p, shift),
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
    print(f"image path: {N_VIEWPOINTS} volumes at batch {BATCH} "
          f"(ViT-B/{VIT_PATCH}, {VIT_LAYERS} layers, {VIT_HEADS} heads, "
          f"{size} x {size}), deform launches {launches}")
    return images, vols


def agent_volumes(ver, graphs, vols):
    """Phase 8, step 2: one synthetic viewpoint per token through the VER
    product path on the card (the get_occ.py model of phase 4, its seed-0
    weights, batch 4, the last batch padded and the padding dropped);
    each dump-layout volume read back as load_ver_features reads it.
    Returns {token: (900, C) volume}."""
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
    dumped, ovf, launches, nq = counted(make_bev_only(model), batches, ver)
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
    print(f"agent volumes: {len(tokens)} viewpoints through the VER path "
          f"at batch {BATCH} ({len(batches)} batches, {pad} padding), "
          f"deform launches {launches}, backward 0")
    return out


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


def agent_path(ver):
    """Phase 8; returns its numbers and (the policy's config, the
    episodes, graphs and volumes) for the phases after it."""
    import tempfile

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
    with tempfile.TemporaryDirectory() as root:
        episodes, graphs, vols = make_synthetic_vln(
            root, num_scans=AGENT_SCANS, nodes_per_scan=AGENT_NODES,
            num_episodes=AGENT_EPISODES,
            bev_num=cfg.bev_z * cfg.bev_h * cfg.bev_w,
            embed_dims=cfg.embed_dims, vocab=AGENT_VOCAB,
            max_text_len=AGENT_TEXT_LEN, seed=0)
    vols = agent_volumes(ver, graphs, vols)
    env = R2REnv(episodes, graphs, vols, max_nodes=cfg.max_nodes)
    policy = build_policy(cfg, "cuda", seed=2)
    n_params = sum(p.numel() for p in policy.parameters())
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

    # card vs CPU: the batch-8 rollouts of every episode recorded on the
    # card, each policy call replayed on the CPU port with the same weights
    # and inputs
    with replay.PolicyCalls(policy) as rec:
        for lo in range(0, AGENT_EPISODES, AGENT_BATCH):
            run_episodes_batched(policy, env, list(range(
                lo, min(lo + AGENT_BATCH, AGENT_EPISODES))), cfg)
    cpu_policy = build_policy(cfg, "cpu", seed=2)
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
    out = dict(agent_params=n_params,
               agent_max_abs_err_logits=held["worst"]["logits"])
    return out, (cfg, episodes, graphs, vols)


def agent_hold(name, cpu_model, card_model, loss_of, card):
    """Phase 9: one update's losses and gradients on the card against the
    CPU's, from the same weights and batch, dropout off, the card's ReLUs
    pinned to the CPU run's masks (agent/replay.py's bounds)."""
    from vln_ver_tpu_torch.agent.replay import (GRAD_REL_L2, LOSS_RTOL,
                                                hold_update, loss_and_grads)
    masks = []
    t0 = time.perf_counter()
    ref = loss_and_grads(cpu_model, loss_of(cpu_model, "cpu"), record=masks)
    cpu_s = time.perf_counter() - t0
    got = loss_and_grads(card_model, loss_of(card_model, "cuda"), pin=masks)
    try:
        held = hold_update(got, ref)
    except AssertionError as e:
        fail(f"{name}: {e}")
    print(f"{name} card vs CPU (one update, dropout off, {got['flips']} "
          f"ReLU elements pinned to the CPU's masks): losses "
          + ", ".join(f"{k} {v:.6f}" for k, v in got["parts"].items())
          + f"; worst relative loss difference {held['loss'][0]:.3e} "
          f"({held['loss'][1]}) (rtol {LOSS_RTOL}); worst relative gradient "
          f"L2 difference {held['grad'][0]:.3e} ({held['grad'][1]}), global "
          f"norm {ref['gnorm']:.6f} within {held['gnorm']:.3e} (bound "
          f"{GRAD_REL_L2}); the CPU took {cpu_s:.2f}s ok [{card}]")


def checked_updates(name, updates, lossy):
    """AGENT_TRAIN_UPDATES updates of the generator ``updates``; fails
    unless every loss is finite.  Returns the total losses."""
    losses = [lossy(next(updates)) for _ in range(AGENT_TRAIN_UPDATES)]
    host = [{k: float(v) for k, v in parts.items()} | {"loss": float(loss)}
            for loss, parts in losses]
    bad = [i for i, m in enumerate(host)
           if not all(np.isfinite(v) for v in m.values())]
    if bad:
        fail(f"{name}: non-finite losses at updates {bad}: {host}")
    print(f"{name}: {AGENT_TRAIN_UPDATES} updates, losses "
          + " ".join(f"{m['loss']:.4f}" for m in host))
    return [m["loss"] for m in host]


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
    agent_hold(
        f"agent pretraining ({n_pre} parameters, batch {PRETRAIN_BATCH})",
        model.eval(), card_model.eval(), pretrain_loss_of, card)
    del model
    model = card_model.train()
    before = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    torch.manual_seed(0)
    updates = pretrain_updates(
        model, make_train_state(model, PRETRAIN_LR), records, PRETRAIN_BATCH,
        np.random.default_rng(0), torch.Generator("cuda").manual_seed(11),
        "cuda")
    out["pretrain_losses"] = checked_updates(
        f"agent pretraining at batch {PRETRAIN_BATCH} (dropout on, "
        f"{len(records)} offline records)", updates, lambda u: u[1:])
    out["pretrain_max_param_change"] = moved(before, model)
    print(f"agent pretraining: largest parameter change "
          f"{out['pretrain_max_param_change']:.3e}")
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

    agent_hold(
        f"agent imitation ({sum(p.numel() for p in policy.parameters())} "
        f"parameters, {DAGGER_UPDATE_BATCH} steps of sampled rollouts)",
        build_policy(cfg, "cpu", seed=2), policy, imitation_loss_of, card)
    before = [p.detach().to("cpu", copy=True)
              for p in policy.parameters()]
    updates = dagger_updates(
        policy, make_train_state(policy, DAGGER_LR), env, cfg,
        np.random.default_rng(0), gen, "cuda",
        sample_prob=DAGGER_SAMPLE_PROB, episode_batch=DAGGER_EPISODE_BATCH,
        update_batch=DAGGER_UPDATE_BATCH)
    out["dagger_losses"] = checked_updates(
        f"agent imitation with DAgger (sample prob {DAGGER_SAMPLE_PROB}, "
        f"episode batch {DAGGER_EPISODE_BATCH}, update batch "
        f"{DAGGER_UPDATE_BATCH}, dropout off)", updates, lambda u: u[1:])
    step = AGENT_TRAIN_UPDATES * DAGGER_UPDATE_BATCH
    out["dagger_max_param_change"] = moved(before, policy)
    print(f"agent imitation: largest parameter change "
          f"{out['dagger_max_param_change']:.3e}")
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
    if KERNEL.launches or KERNEL_BWD.launches:
        fail(f"phase 9 launched the deform kernels ({KERNEL.launches}, "
             f"{KERNEL_BWD.launches}): it trains on phase 8's volumes")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"agent training phase: {out['seconds']:.2f}s, deform launches "
          f"forward 0, backward 0 [{card}]")
    return out


def _serve_args(config, queue, **kw):
    import argparse
    base = dict(config=os.path.join(REPO, config), cfg_options=None,
                checkpoint=None, queue=queue, batch_max=SERVE_BATCH,
                poll_ms=5, occupancy=False, max_requests=None, images=False,
                vit_checkpoint=None, hf_prefix="", vit_patch_size=VIT_PATCH,
                vit_layers=VIT_LAYERS, vit_heads=VIT_HEADS, device="cuda")
    base.update(kw)
    return argparse.Namespace(**base)


def _enqueue(queue, reqs):
    """Write ``{id: arrays}`` as request files, as a client does (a
    dotfile, then a rename); returns the inbox."""
    inbox = os.path.join(queue, "in")
    os.makedirs(inbox, exist_ok=True)
    for rid, arrays in reqs.items():
        tmp = os.path.join(inbox, f".{rid}.tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, os.path.join(inbox, f"{rid}.npz"))
    return inbox


def _response(queue, rid):
    with np.load(os.path.join(queue, "out", f"{rid}.npz")) as z:
        return {k: z[k] for k in z.files}


def _served_batches(reqs, batch_max, malformed=()):
    """The server's micro-batches of ``reqs``: claims of ``batch_max``
    names in sorted order (``malformed`` ids take their places in the
    claims and are served by none), each split into its feature and image
    requests (in that order) and padded by repeating its last row: [(ids,
    padded (inputs, w2p, shift))]."""
    out = []
    names = sorted(list(reqs) + list(malformed))
    for lo in range(0, len(names), batch_max):
        chunk = names[lo:lo + batch_max]
        for key in ("features", "images"):
            ids = [r for r in chunk if r in reqs and key in reqs[r]]
            if not ids:
                continue
            rows = ids + [ids[-1]] * (batch_max - len(ids))
            out.append((ids, tuple(np.stack([reqs[r][k] for r in rows])
                                   for k in (key, "world2pixel",
                                             "origin_shift"))))
    return out


def serving(ver, feats, w2p, shift, dense_vols, images, image_vols, samples):
    """Phase 10."""
    import tempfile

    import torch

    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.models.vit import vit_for_ver
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.serve import make_forward, serve
    from vln_ver_tpu_torch.ver_writer import volumes_from_bev

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    queue = os.path.join(root, "q")
    reqs = {f"f{i:02d}": _request(feats, w2p, shift, "features", i)
            for i in range(SERVE_FEATURE_REQUESTS)}
    reqs.update({f"i{i:02d}": _request(images, w2p, shift, "images", i)
                 for i in range(SERVE_IMAGE_REQUESTS)})
    inbox = _enqueue(queue, reqs)
    # first in the claim order: it shares a claim with served requests
    bad = os.path.join(inbox, "a-bad.npz")
    np.savez(bad, features=np.zeros((1, 2, 2, 3), np.float32),
             world2pixel=np.zeros((1, 4, 4), np.float32),
             origin_shift=np.zeros(3, np.float32))
    old = time.time() - 60      # an old write: malformed, not half-written
    os.utime(bad, (old, old))

    times = []
    KERNEL.launches = KERNEL_BWD.launches = 0
    served = serve(_serve_args("configs/verformer/get_occ.py", queue,
                               images=True, max_requests=len(reqs)),
                   times=times)
    launches, bwd = KERNEL.launches, KERNEL_BWD.launches
    batches = _served_batches(reqs, SERVE_BATCH, malformed=("a-bad",))
    nb = sum(t["batches"] for t in times)
    if served != len(reqs) or nb != len(batches):
        fail(f"the server served {served} requests in {nb} batches, "
             f"expected {len(reqs)} in {len(batches)}")
    if launches != ver.encoder_layers * len(batches) or bwd:
        fail(f"the server launched the forward kernel {launches} times and "
             f"the backward {bwd} times over {len(batches)} batches, "
             f"expected {ver.encoder_layers} a batch and none")
    if not os.path.exists(os.path.join(queue, "out", "a-bad.error.txt")):
        fail("the malformed request got no error file")

    # every volume against a direct call on the same padded batch (exact)
    # and against phases 4 and 4d's volumes of the viewpoint (1e-5)
    model = build_model(ver, "cuda", seed=0)
    vit = vit_for_ver(ver, VIT_PATCH, VIT_LAYERS, VIT_HEADS).init_weights(
        torch.Generator().manual_seed(1)).cuda().eval()
    direct = {"features": make_bev_only(model),
              "images": make_bev_only(model, vit)}
    exact_err = phase_err = 0.0
    for ids, arrays in batches:
        key = "images" if ids[0].startswith("i") else "features"
        bev, _ = direct[key](*(torch.from_numpy(a).cuda() for a in arrays))
        want = volumes_from_bev(bev.float().cpu().numpy(), ver)
        for j, rid in enumerate(ids):
            got = _response(queue, rid)["volume"]
            exact_err = max(exact_err, float(np.abs(got - want[j]).max()))
            ref = (image_vols if key == "images" else dense_vols)[
                int(rid[1:])]
            phase_err = max(phase_err, float(np.abs(got - ref).max()))
    ok = exact_err == 0.0 and phase_err <= 1e-5
    print(f"server: {served} requests ({SERVE_FEATURE_REQUESTS} feature, "
          f"{SERVE_IMAGE_REQUESTS} image) + 1 malformed at batch_max "
          f"{SERVE_BATCH} in {nb} batches, {launches} deform launches; "
          f"volumes vs direct make_bev_only calls on the same padded "
          f"batches: max_abs_err={exact_err:.3e} (exact); vs phases 4 and "
          f"4d: max_abs_err={phase_err:.3e} (atol 1e-5) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("served volumes disagree with the direct forward")
    del model, vit, direct

    # --occupancy at vocc.py width on phase 6's viewpoints
    vocc = build_ver_config(load_config(
        os.path.join(REPO, "configs/verformer/vocc.py")))
    oq = os.path.join(root, "occ")
    occ_reqs = {f"o{i}": {k: samples[i][k] for k in
                          ("features", "world2pixel", "origin_shift")}
                for i in range(SERVE_OCC_BATCH)}
    _enqueue(oq, occ_reqs)
    KERNEL.launches = 0
    served = serve(_serve_args("configs/verformer/vocc.py", oq,
                               occupancy=True, batch_max=SERVE_OCC_BATCH,
                               max_requests=SERVE_OCC_BATCH))
    occ_launches = KERNEL.launches
    model = build_model(vocc, "cuda", seed=0)
    (ids, arrays), = _served_batches(occ_reqs, SERVE_OCC_BATCH)
    bev, labels = make_forward(model, vocc, occupancy=True)(
        *(torch.from_numpy(a).cuda() for a in arrays))
    labels = labels.cpu().numpy()
    vols = volumes_from_bev(bev.float().cpu().numpy(), vocc)
    same = served == SERVE_OCC_BATCH and occ_launches == vocc.encoder_layers
    for j, rid in enumerate(ids):
        got = _response(oq, rid)
        same &= bool(np.array_equal(got["occupancy"], labels[j])
                     and got["occupancy"].dtype == np.int32
                     and np.array_equal(got["volume"], vols[j]))
    print(f"server --occupancy (vocc.py, batch_max {SERVE_OCC_BATCH}): "
          f"{served} requests, labels of {labels.shape[1]} voxels and "
          f"volumes equal to a direct forward + decode_occupancy on the "
          f"card, {occ_launches} deform launches "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        fail("the occupancy server disagrees with the direct forward")
    shutil.rmtree(root)


def _request(inputs, w2p, shift, key, i):
    return {key: inputs[i], "world2pixel": w2p[i], "origin_shift": shift[i]}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def nccl_world_one():
    """An NCCL process group of world 1 (``parallel.multihost``, a local
    address and a free port) around the block; yields the rank's device,
    destroys the group and restores the environment after."""
    import torch

    from vln_ver_tpu_torch.parallel import multihost
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    try:
        dev = multihost.initialize_if_needed("cuda")
        print(f"process group: backend {torch.distributed.get_backend()}, "
              f"world {multihost.process_count()}, device {dev}")
        yield dev
    finally:
        multihost.shutdown()
        for k in env:
            os.environ.pop(k, None)


def mesh_world_one(ver, feats, w2p, shift, dense_vols, samples, agent_env,
                   card):
    """Phase 10b.  The lift runs on a view shard
    of the world group (index 0 of 1), so its all-reduces of the slot sums
    and hit counts, and of the sparse lift's overflow, run under NCCL."""
    import torch

    from vln_ver_tpu_torch.agent.env import R2REnv
    from vln_ver_tpu_torch.agent.policy import build_policy
    from vln_ver_tpu_torch.agent.rollout import (episode_metrics,
                                                 evaluate_batched,
                                                 mean_metrics)
    from vln_ver_tpu_torch.config import build_train_config, load_config
    from vln_ver_tpu_torch.data.mp3d import collate
    from vln_ver_tpu_torch.evaluation.runner import evaluate_model
    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.parallel.mesh import ViewShard, make_mesh, replicate
    from vln_ver_tpu_torch.ver_writer import dump_volumes

    with nccl_world_one() as dev:
        mesh = make_mesh((1, 1))
        views = ViewShard(torch.distributed.group.WORLD, 0, 1)
        dataset = [dict(features=feats[i], world2pixel=w2p[i],
                        origin_shift=shift[i], token=f"vp{i:02d}")
                   for i in range(N_VIEWPOINTS)]
        n_batches = -(-N_VIEWPOINTS // BATCH)
        model = replicate(mesh, build_model(ver, dev, seed=0))
        # the dense lift (exact) and the sparse lift (phase 4b's bound)
        for name, cfg, atol in (
                ("dense", ver, 0.0),
                ("sparse", dataclasses.replace(
                    ver, sca_query_capacity=SPARSE_K), 1e-5)):
            lift = build_model(cfg, dev, seed=0)
            lift.load_state_dict(model.state_dict(), strict=True)
            lift.shard_views(views)
            store = MemoryH5()
            store.keep = {d["token"] for d in dataset}
            KERNEL.launches = KERNEL_BWD.launches = 0
            with store.installed():
                res = dump_volumes(make_bev_only(lift), dataset, ver,
                                   f"mesh_{name}.hdf5", batch_size=BATCH,
                                   device=dev, mesh=mesh)
            err = max(float(np.abs(store.kept[f"vp{i:02d}"]
                                   - dense_vols[i]).max())
                      for i in range(N_VIEWPOINTS))
            ok = (res["written"] == N_VIEWPOINTS and res["sca_overflow"] == 0
                  and err <= atol and not KERNEL_BWD.launches
                  and KERNEL.launches == ver.encoder_layers * n_batches)
            print(f"dump_volumes(mesh=make_mesh((1, 1))), {name} lift on a "
                  f"view shard, under NCCL: {res['written']} volumes, "
                  f"sca_overflow {res['sca_overflow']}, max_abs_err="
                  f"{err:.3e} against phase 4's (atol {atol}), "
                  f"{KERNEL.launches} deform launches "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the {name} mesh dump disagrees with phase 4")
            del lift, store
        del model

        # one train --mesh 1 step on the view shard against phase 7's
        # plain step
        cfg = load_config(os.path.join(REPO, "configs/verformer/vocc.py"))
        batch = int(cfg["data"]["samples_per_gpu"])
        tc = build_train_config(cfg, len(samples) // batch)
        host_batch = collate(samples[:batch])
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            plain = card_step(ver, tc, host_batch)
            meshed = card_step(ver, tc, host_batch, mesh=mesh, views=views)
        finally:
            torch.backends.cudnn.deterministic = saved
        hold_step("train --mesh 1 step on a view shard under NCCL vs the "
                  "plain step (card)", meshed, plain, 1e-6, 1e-6, card)

        # test --mesh 1: the rows gathered and the histograms summed
        # through NCCL, against the one-process eval (phase 6's split)
        classes = tuple(cfg["data"]["test"].get("classes", ()))
        model = build_model(ver, dev, seed=0)
        plain = evaluate_model(model, samples, occ_thresholds=(0.25,),
                               batch_size=EVAL_BATCH, classes=classes)
        KERNEL.launches = KERNEL_BWD.launches = 0
        meshed = evaluate_model(model, samples, occ_thresholds=(0.25,),
                                batch_size=EVAL_BATCH, classes=classes,
                                mesh=mesh)
        ok = meshed == plain and KERNEL.launches == ver.encoder_layers * (
            -(-len(samples) // EVAL_BATCH))
        print(f"evaluate_model(mesh=make_mesh((1, 1))) under NCCL: "
              f"{len(samples)} viewpoints, {len(meshed)} metrics equal to "
              f"the one-process eval's, {KERNEL.launches} deform launches "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the mesh eval disagrees with the one-process eval")
        del model

        # test_vln --mesh 1: the episodes' metrics gathered through NCCL
        acfg, episodes, graphs, vols = agent_env
        aenv = R2REnv(episodes[:AGENT_EPISODES], graphs, vols,
                      max_nodes=acfg.max_nodes)
        policy = build_policy(acfg, "cuda", seed=2)
        one = episode_metrics(policy, aenv, acfg, batch_size=AGENT_BATCH)
        per_ep = episode_metrics(policy, aenv, acfg, batch_size=AGENT_BATCH,
                                 mesh=mesh)
        means = evaluate_batched(policy, aenv, acfg, batch_size=AGENT_BATCH,
                                 mesh=mesh)
        ok = per_ep == one and means == mean_metrics(one)
        print(f"episode_metrics / evaluate_batched(mesh=make_mesh((1, 1))) "
              f"under NCCL: {len(per_ep)} episodes' metrics equal to the "
              f"one-process run's {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the mesh agent eval disagrees with the one-process run")


def grids_world_one(ver, weights, samples, card):
    """Phase 10c; returns its numbers."""
    import torch

    from vln_ver_tpu_torch import geometry
    from vln_ver_tpu_torch.config import build_train_config, load_config
    from vln_ver_tpu_torch.data.mp3d import collate
    from vln_ver_tpu_torch.models.encoder import VoxelEncoderLayer
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.parallel import tensor
    from vln_ver_tpu_torch.parallel.mesh import make_multislice_mesh
    from vln_ver_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                     pipeline_apply,
                                                     sequential_apply)

    t_phase = time.perf_counter()
    numbers = {}
    with nccl_world_one() as dev:
        # train --tp-model and --mesh S,D,V steps against the plain step,
        # as phase 10b holds its train --mesh step
        cfg = load_config(os.path.join(REPO, "configs/verformer/vocc.py"))
        batch = int(cfg["data"]["samples_per_gpu"])
        tc = build_train_config(cfg, len(samples) // batch)
        host_batch = collate(samples[:batch])
        tp_mesh = tensor.make_tp_mesh(1, 1, 1)
        states = []
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            plain = card_step(ver, tc, host_batch, weights=weights,
                              keep=states)
            tp = card_step(ver, tc, host_batch, mesh=tp_mesh,
                           weights=weights, tp=True, keep=states)
            sliced = card_step(ver, tc, host_batch,
                               mesh=make_multislice_mesh(1, 1, 1),
                               weights=weights)
        finally:
            torch.backends.cudnn.deterministic = saved
        hold_step("train --tp-model 1 step (make_tp_mesh(1, 1, 1), "
                  "shard_state) under NCCL vs the plain step (card)", tp,
                  plain, 1e-6, 1e-6, card)
        hold_step("train --mesh 1,1,1 step (make_multislice_mesh(1, 1, 1)) "
                  "under NCCL vs the plain step (card)", sliced, plain, 1e-6,
                  1e-6, card)
        mib = 2 ** 20
        numbers.update(
            tp_fraction=tensor.tp_fraction(states[1], tp_mesh),
            tp_resident_mib=tensor.resident_bytes(states[1]) / mib,
            replicated_resident_mib=tensor.resident_bytes(states[0]) / mib,
            **{f"tp_rule_mib_model{m}": tensor.rule_bytes(states[0], m) / mib
               for m in (1, 2, 4, 8)})
        del states, plain, tp, sliced
        print(f"tensor parallelism at vocc.py width: tp_fraction "
              f"{numbers['tp_fraction']:.6f} of the parameter elements "
              f"sharded; at rest (parameters and AdamW moments, fp32) "
              f"{numbers['tp_resident_mib']:.2f} MiB a rank sharded over 1 "
              f"against {numbers['replicated_resident_mib']:.2f} MiB "
              f"replicated; by param_pspec at model 1 / 2 / 4 / 8: "
              + " / ".join(f"{numbers[f'tp_rule_mib_model{m}']:.2f}"
                           for m in (1, 2, 4, 8)) + " MiB a rank")
        if not (numbers["tp_resident_mib"] == numbers["replicated_resident_mib"]
                == numbers["tp_rule_mib_model1"]):
            fail("the sharded state's bytes at rest are not the rule's")

        # pipeline_apply at stage 1 over 4 encoder layers at get_occ.py
        # width (the seed-0 model's three and a copy of its first) on 4
        # of phase 6's viewpoints, against sequential_apply
        layers = torch.nn.ModuleList([VoxelEncoderLayer(ver)
                                      for _ in range(4)])
        prefix = "pts_bbox_head.transformer.encoder.layers."
        for i, layer in enumerate(layers):
            pre = f"{prefix}{i % ver.encoder_layers}."
            layer.load_state_dict({k[len(pre):]: v for k, v in
                                   weights.items() if k.startswith(pre)})
        layers = layers.to(dev).eval()
        rows = collate(samples[:4])
        feats = torch.from_numpy(rows["features"]).to(dev)
        b = feats.shape[0]
        value = feats.reshape(b, ver.num_cams, ver.feat_h * ver.feat_w,
                              ver.in_channels).requires_grad_(True)
        ref3d = geometry.voxel_reference_points(ver.bev_z, ver.bev_h,
                                                ver.bev_w, device=dev)
        cam_xy, mask = geometry.project_reference_points(
            ref3d, torch.from_numpy(rows["world2pixel"]).to(dev),
            torch.from_numpy(rows["origin_shift"]).to(dev),
            pc_range=ver.pc_range)
        cam_xy, mask = cam_xy[:, :, :, None, :], mask[:, :, :, None]
        gen = torch.Generator().manual_seed(6)
        query = torch.randn((b, ver.bev_num, ver.embed_dims),
                            generator=gen).to(dev).requires_grad_(True)
        shapes = ((ver.feat_h, ver.feat_w),)

        def layer_fn(layer, h, value, cam_xy, mask):
            return layer(h, value, cam_xy, mask, shapes)

        def run(micro):
            layers.zero_grad(set_to_none=True)
            query.grad = value.grad = None
            KERNEL.launches = KERNEL_BWD.launches = 0
            args = (layer_fn, layers, query, value, cam_xy, mask)
            out = (sequential_apply(*args) if micro is None else
                   pipeline_apply(make_pp_mesh(1), *args,
                                  microbatches=micro))
            (out ** 2).sum().backward()
            torch.cuda.synchronize()
            return (out.detach(), [query.grad, value.grad]
                    + [p.grad for p in layers.parameters()],
                    (KERNEL.launches, KERNEL_BWD.launches))

        ref = run(None)
        for micro in (2, 4):
            out, grads, got = run(micro)
            err = float((out - ref[0]).abs().max())
            ok_out = bool(torch.allclose(out, ref[0], rtol=2e-5, atol=2e-5))
            bad = [i for i, (g, r) in enumerate(zip(grads, ref[1]))
                   if not torch.allclose(g, r, rtol=5e-4, atol=5e-5)]
            gerr = max(float((g - r).abs().max())
                       for g, r in zip(grads, ref[1]))
            want = (4 * micro, 4 * micro)
            print(f"pipeline_apply(make_pp_mesh(1), 4 encoder layers, "
                  f"microbatches={micro}) under NCCL vs sequential_apply at "
                  f"batch {b}: max_abs_err={err:.3e} (rtol and atol 2e-5), "
                  f"gradients of sum(out**2) max_abs_err={gerr:.3e} over "
                  f"{len(grads)} tensors (rtol 5e-4, atol 5e-5), deform "
                  f"launches forward + backward {got} (expected {want}) "
                  f"{'ok' if ok_out and not bad and got == want else 'FAIL'}"
                  f" [{card}]")
            numbers[f"pipeline_m{micro}_max_abs_err"] = err
            numbers[f"pipeline_m{micro}_grad_max_abs_err"] = gerr
            if not ok_out or bad or got != want:
                fail(f"the pipeline at {micro} microbatches: outputs "
                     f"{'ok' if ok_out else 'differ'}, gradients {bad[:5]} "
                     f"differ, launches {got} (expected {want})")
    print(f"phase 10c: {time.perf_counter() - t_phase:.2f}s")
    return numbers


def path_shape_timing(card):
    """Phase 5 at the launches of phases 11 and 12 (PATH_SHAPES), fp32:
    each kernel's graph time against its plain version, its bound and its
    shared-memory floor, and the bf16 graph times.  Returns {shape name:
    numbers}."""
    import torch

    from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    dev = torch.device("cuda")
    out = {}
    for i, (name, bs, H, W, d, nq, P) in enumerate(PATH_SHAPES):
        hw = ((H, W),)
        r = {}
        for dt in (torch.float32, torch.bfloat16):
            v, loc, w = deform_inputs(bs, H * W, 8, d, nq, P, dt, 30 + i, dev)
            g = grad_out_like(bs, nq, 8, d, dt, 40 + i, dev)
            with torch.inference_mode():
                ms = time_graph_ms(lambda: KERNEL(v, hw, loc, w))
            bwd_ms = time_graph_ms(lambda: KERNEL_BWD(v, hw, loc, w, g))
            if dt is torch.bfloat16:
                r.update(ms_bf16=ms, bwd_ms_bf16=bwd_ms)
                continue
            with torch.inference_mode():
                plain_ms = time_ms(lambda: ms_deform_attn_2d(v, hw, loc, w),
                                   iters=20, warmup=3)
            ins = [t.detach().requires_grad_() for t in (v, loc, w)]
            o = ms_deform_attn_2d(ins[0], hw, ins[1], ins[2])
            bwd_plain_ms = time_ms(lambda: torch.autograd.grad(
                o, ins, g, retain_graph=True), iters=20, warmup=3)
            del o, ins
            bound_ms, bound_by = deform_bound(v, loc, (H, W))
            bwd_bound_ms, bwd_bound_by = deform_bound(v, loc, (H, W),
                                                      backward=True)
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by,
                     smem_floor_ms=smem_floor_ms(v, loc, (H, W)),
                     bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                     bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by,
                     bwd_smem_floor_ms=smem_floor_ms(v, loc, (H, W),
                                                     backward=True))
        out[name] = r
        print(f"deform_attn_2d {name} (bs={bs}, {H}x{W}, d={d}, nq={nq}, "
              f"P={P}): kernel {r['ms']:.4f} ms (graph; bf16 "
              f"{r['ms_bf16']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
              f"shared-memory floor {r['smem_floor_ms']:.4f} ms; backward "
              f"{r['bwd_ms']:.4f} ms (bf16 {r['bwd_ms_bf16']:.4f}), plain "
              f"{r['bwd_plain_ms']:.4f} ms, bound {r['bwd_bound_ms']:.4f} ms "
              f"({r['bwd_bound_by']}), "
              f"{100 * r['bwd_bound_ms'] / r['bwd_ms']:.1f}% of bound, "
              f"shared-memory floor {r['bwd_smem_floor_ms']:.4f} ms [{card}]")
    return out


def headline_shape_timing(card):
    """Phase 5 at phase 13's 36-view launches (HEADLINE_SHAPES): the
    forward's graph time, fp32 and bf16, against the plain version (over
    blocks of PLAIN_SLOTS slots), its bytes bound and shared-memory floor;
    the same for the backward where the shape has one, against the plain
    version's autograd.  Returns {shape name: numbers}."""
    import torch

    from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    dev = torch.device("cuda")
    H = W = 14
    hw = ((H, W),)
    out = {}
    for i, (name, bs, nq, backward) in enumerate(HEADLINE_SHAPES):
        r = {}
        for dt in (torch.float32, torch.bfloat16):
            v, loc, w = deform_inputs(bs, H * W, 8, 96, nq, 8, dt, 50 + i,
                                      dev)
            with torch.inference_mode():
                ms = time_graph_ms(lambda: KERNEL(v, hw, loc, w))
            if backward:
                g = grad_out_like(bs, nq, 8, 96, dt, 60 + i, dev)
                bwd_ms = time_graph_ms(lambda: KERNEL_BWD(v, hw, loc, w, g))
            if dt is torch.bfloat16:
                r["ms_bf16"] = ms
                if backward:
                    r["bwd_ms_bf16"] = bwd_ms
                continue
            with torch.inference_mode():
                plain_ms = time_ms(lambda: plain_forward(v, (H, W), loc, w),
                                   iters=10, warmup=2)
            bound_ms, bound_by = deform_bound(v, loc, (H, W))
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, plan=KERNEL.plan(
                         bs, 8, nq, H * W, 96, 4, dev)._asdict(),
                     smem_floor_ms=smem_floor_ms(v, loc, (H, W)))
            if backward:
                ins = [t.detach().requires_grad_() for t in (v, loc, w)]
                o = ms_deform_attn_2d(ins[0], hw, ins[1], ins[2])
                bwd_plain_ms = time_ms(lambda: torch.autograd.grad(
                    o, ins, g, retain_graph=True), iters=10, warmup=2)
                del o, ins
                bwd_bound_ms, bwd_bound_by = deform_bound(
                    v, loc, (H, W), backward=True)
                r.update(bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                         bwd_bound_ms=bwd_bound_ms,
                         bwd_bound_by=bwd_bound_by,
                         bwd_plan=KERNEL_BWD.plan(
                             bs, 8, nq, H * W, 96, 4, dev, True,
                             True)._asdict(),
                         bwd_smem_floor_ms=smem_floor_ms(v, loc, (H, W),
                                                         backward=True))
        out[name] = r
        line = (f"deform_attn_2d {name} (bs={bs}, nq={nq}): kernel "
                f"{r['ms']:.4f} ms (graph; bf16 {r['ms_bf16']:.4f}), plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of bound, shared-memory floor {r['smem_floor_ms']:.4f} ms, "
                f"plan {r['plan']}")
        if backward:
            line += (f"; backward {r['bwd_ms']:.4f} ms (bf16 "
                     f"{r['bwd_ms_bf16']:.4f}), plain {r['bwd_plain_ms']:.4f}"
                     f" ms, bound {r['bwd_bound_ms']:.4f} ms "
                     f"({r['bwd_bound_by']}), "
                     f"{100 * r['bwd_bound_ms'] / r['bwd_ms']:.1f}% of bound,"
                     f" shared-memory floor {r['bwd_smem_floor_ms']:.4f} ms, "
                     f"plan {r['bwd_plan']}")
        print(f"{line} [{card}]")
    return out


def _moving_viewpoints(cfg, n, t_len, seed):
    """(features, world2pixel, origin_shift) queues (n, t_len, ...): each
    viewpoint walks a straight line at up to 0.5 m a frame, six cameras
    around it."""
    from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (n, t_len, cfg.num_cams, cfg.feat_h, cfg.feat_w,
         cfg.in_channels)).astype(np.float32)
    start = rng.uniform(-1.0, 1.0, (n, 1, 3)) * np.array([1, 1, 0.3])
    step = rng.uniform(-0.5, 0.5, (n, 1, 3)) * np.array([1, 1, 0.1])
    pos = (start + step * np.arange(t_len)[None, :, None]).astype(np.float32)
    w2p = np.stack([[np.stack([
        make_pinhole_world2pixel(70.0, deg * 360.0 / cfg.num_cams, p)
        for deg in range(cfg.num_cams)]) for p in row] for row in pos])
    return feats, w2p.astype(np.float32), pos


def temporal_path(ver, samples, card):
    """Phase 11: the temporal VER model (TSA) at get_occ.py / vocc.py
    widths and its decoder_on_bev head."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vln_ver_tpu_torch.config import build_train_config, load_config
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.utils.profiling import recorded

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    tsa = dataclasses.replace(ver, use_temporal_self_attn=True)
    frames = TEMPORAL_FRAMES + 1
    feats, w2p, pos = _moving_viewpoints(tsa, TEMPORAL_BATCH, frames, 11)
    extent = (np.asarray(tsa.pc_range[3:], np.float32)
              - np.asarray(tsa.pc_range[:3], np.float32))
    shift = (pos[:, -1] - pos[:, -2]) / extent

    def staged(device, rows):
        """The history queues, the current frame and the shift of the
        first ``rows`` viewpoints on ``device``."""
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[:rows])).to(device)
        return ([t(a[:, :-1]) for a in (feats, w2p, pos)],
                [t(a[:, -1]) for a in (feats, w2p, pos)], t(shift))

    def history_run(model, inputs):
        """obtain_history_bev over the first frames, then the current
        frame's only_bev forward with prev_bev and the derived shift."""
        queues, current, tsa_shift = inputs
        prev = model.obtain_history_bev(*queues)
        with torch.inference_mode():
            cur = model(*current, prev_bev=prev, tsa_shift=tsa_shift,
                        only_bev=True)["bev_embed"]
        return prev, cur

    model = build_model(tsa, dev, seed=0)
    KERNEL.launches = KERNEL_BWD.launches = 0
    prev, cur = history_run(model, staged(dev, TEMPORAL_BATCH))
    launches = KERNEL.launches
    if launches != tsa.encoder_layers * frames or KERNEL_BWD.launches:
        fail(f"the history run launched the kernels {launches} and "
             f"{KERNEL_BWD.launches} times, expected {tsa.encoder_layers} "
             f"x {frames} frames and none")
    del model
    t0 = time.perf_counter()
    cpu_prev, cpu_cur = history_run(build_model(tsa, "cpu", seed=0),
                                    staged("cpu", TEMPORAL_CPU_ROWS))
    cpu_s = time.perf_counter() - t0
    for name, got, ref in (("history bev (frame 3)", prev, cpu_prev),
                           ("current frame bev_embed", cur, cpu_cur)):
        err, ok = close(got[:TEMPORAL_CPU_ROWS].float().cpu(), ref, 1e-4,
                        1e-4)
        print(f"temporal {name} card vs CPU ({TEMPORAL_CPU_ROWS} of "
              f"{TEMPORAL_BATCH} viewpoints, {TEMPORAL_FRAMES} history "
              f"frames, moving origins): max_abs_err={err:.3e} (rtol=1e-4, "
              f"atol=1e-4) {'ok' if ok else 'FAIL'}")
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"the temporal {name} disagrees with the CPU run")
    print(f"temporal history run: {TEMPORAL_BATCH} viewpoints x {frames} "
          f"frames, deform launches {launches}; the CPU took {cpu_s:.2f}s")

    # the full forward with decoder_on_bev at the eval batch, on the
    # history's last two viewpoints: its launches at the full grid, held
    # against the CPU on the 0.2 m grid
    rows = slice(0, EVAL_BATCH)
    inputs = [torch.from_numpy(np.ascontiguousarray(a[rows, -1]))
              for a in (feats, w2p, pos)]
    extra = dict(prev_bev=prev[rows].float().cpu(),
                 tsa_shift=torch.from_numpy(shift[rows]))
    enc, dec = tsa.encoder_layers, tsa.decoder_layers
    for kind in ("mlp", "pool"):
        cfg = dataclasses.replace(tsa, decoder_on_bev=True,
                                  voxel_2_bev_type=kind)
        model = build_model(cfg, dev, seed=0)
        args = [t.to(dev) for t in inputs]
        kw = {k: v.to(dev) for k, v in extra.items()}
        # the first forward captures the decoder's CUDA graph, launching
        # its kernels from the host twice (warm-up and capture); the
        # second replays it, and only the encoder launches from the host
        KERNEL.launches = KERNEL_BWD.launches = 0
        with torch.inference_mode():
            with planned() as nq:
                model(*args, **kw)
            first = KERNEL.launches
            with profile(activities=[ProfilerActivity.CPU]):
                last = model(*args, **kw)
            replays = recorded()["counters"].get("decoder#graph_replays")
        got = (first, nq["fwd"], KERNEL.launches - first, replays,
               KERNEL_BWD.launches)
        want = (enc + 2 * dec, tsa.num_query, enc, 1.0, 0)
        if got != want:
            fail(f"the decoder_on_bev={kind} forwards: (launches of the "
                 f"capturing forward, its last nq, launches of the "
                 f"replaying one, its decoder#graph_replays, backward "
                 f"launches) {got}, expected {want}")
        for k in ("all_cls_scores", "all_bbox_preds", "occupancy_preds"):
            if not bool(torch.isfinite(last[k]).all()):
                fail(f"non-finite {k} with decoder_on_bev={kind}")
        del model, last
        check = dataclasses.replace(cfg, occupancy_size=(0.2, 0.2, 0.2))
        with torch.inference_mode():
            card1 = build_model(check, dev, seed=0)(*args, **kw)
            t0 = time.perf_counter()
            cpu1 = build_model(check, "cpu", seed=0)(*inputs, **extra)
            cpu_s = time.perf_counter() - t0
        for k, atol in (("bev_embed", 1e-4), ("all_cls_scores", 1e-4),
                        ("all_bbox_preds", 1e-4), ("occupancy_preds", 5e-4)):
            err, ok = close(card1[k].cpu(), cpu1[k], 1e-4, atol)
            print(f"decoder_on_bev={kind} {k} card vs CPU ({EVAL_BATCH} "
                  f"viewpoints with prev_bev and tsa_shift, occupancy grid "
                  f"{(check.occ_zdim, check.occ_ydim, check.occ_xdim)}): "
                  f"max_abs_err={err:.3e} (rtol=1e-4, atol={atol}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"card {k} disagrees with the CPU run "
                     f"(decoder_on_bev={kind})")
        print(f"decoder_on_bev={kind} full forward at batch {EVAL_BATCH}: "
              f"(launches of the capturing forward, its last nq, launches "
              f"of the replaying one, its decoder#graph_replays, backward "
              f"launches) {got}; the CPU forward took {cpu_s:.2f}s")

    # training: a TSA + decoder_on_bev=mlp step held against the CPU
    cfg = load_config(os.path.join(REPO, "configs/verformer/vocc.py"))
    tc = build_train_config(cfg, len(samples))
    train_cfg = dataclasses.replace(tsa, decoder_on_bev=True)
    (fwd, bwd), grads = step_card_vs_cpu(
        dataclasses.replace(train_cfg, occupancy_size=(0.2, 0.2, 0.2),
                            dropout_rate=0.0), tc,
        "TSA + decoder_on_bev=mlp, vocc.py widths", card)
    want = tsa.encoder_layers + tsa.decoder_layers
    if (fwd, bwd) != (want, want):
        fail(f"the TSA + decoder_on_bev step launched the kernels {fwd} and "
             f"{bwd} times, expected {want} each")
    dead = [n for n, g in grads.items() if "encoder.layers" in n
            and ".attentions.0." in n and not bool(g.any())]
    if dead:
        fail(f"TSA parameters without a gradient: {dead[:5]}")
    print(f"phase 11: {time.perf_counter() - t_phase:.2f}s")


def gather_bound_ms(bs, shapes, heads, d, nq, P, elt):
    """Least time of one gather launch: the value rows its taps need (at
    most the whole value), fp32 locations and weights and the output, each
    moved once, or 4 taps x d multiply-adds a sample at the fp32 peak,
    whichever is longer."""
    rows = sum(h * w for h, w in shapes)
    samples = bs * nq * heads * len(shapes) * P
    value = min(bs * rows * heads, 4 * samples) * d * elt
    moved = value + samples * 12 + bs * nq * heads * d * elt
    return 1e3 * max(moved / HBM_BYTES_PER_S,
                     8.0 * d * samples / FP32_FLOP_PER_S)


def gather_shapes(card):
    """Phase 12's kernel part: the gather kernel against the plain version
    at BEVFormer-base's three launch shapes (fp32, and bf16 at the lift's),
    each timed with its bound and the plain version's time; every launch
    goes to the gather kernel, none to the staged one."""
    import torch

    from vln_ver_tpu_torch.ops.deform_attn import ms_deform_attn_2d
    from vln_ver_tpu_torch.ops.deform_cuda import (GATHER, KERNEL,
                                                   ms_deform_attn_2d_fused)
    dev = torch.device("cuda")
    numbers = {}
    cases = [(*c, torch.float32) for c in GATHER_SHAPES]
    cases.append((*GATHER_SHAPES[0], torch.bfloat16))
    for name, bs, shapes, d, nq, P, dtype in cases:
        rng = np.random.default_rng(7)
        rows, L, heads = sum(h * w for h, w in shapes), len(shapes), 8
        value = torch.from_numpy(rng.standard_normal(
            (bs, rows, heads, d)).astype(np.float32)).to(dev, dtype)
        loc = torch.from_numpy(rng.uniform(
            -0.1, 1.1, (bs, nq, heads, L, P, 2)).astype(np.float32)).to(dev)
        wgt = torch.from_numpy(rng.standard_normal(
            (bs, nq, heads, L * P)).astype(np.float32)).to(dev).softmax(
                -1).reshape(bs, nq, heads, L, P).contiguous()
        before = (GATHER.launches, KERNEL.launches)
        with torch.inference_mode():
            got = ms_deform_attn_2d_fused(value, shapes, loc, wgt)
            torch.cuda.synchronize()
            want = ms_deform_attn_2d(value.float(), shapes, loc, wgt)
        if (GATHER.launches - before[0], KERNEL.launches - before[1]) \
                != (1, 0):
            fail(f"{name}: the call did not take the gather kernel alone")
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        err, ok = close(got.float(), want.float(), tol, tol)
        tag = f"{name} {str(dtype).split('.')[-1]}"
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"gather kernel {tag}: max_abs_err={err:.3e} against the "
                 "plain version")
        del want
        with torch.inference_mode():
            ms = time_ms(lambda: ms_deform_attn_2d_fused(value, shapes, loc,
                                                         wgt), iters=50,
                         warmup=5)
            plain = time_ms(lambda: ms_deform_attn_2d(value, shapes, loc,
                                                      wgt), iters=3,
                            warmup=1)
        bound = gather_bound_ms(bs, shapes, heads, d, nq, P,
                                value.element_size())
        numbers[tag] = {"ms": ms, "bound_ms": bound,
                        "share": 100.0 * bound / ms, "plain_ms": plain,
                        "max_abs_err": err}
        print(f"gather kernel {tag} (bs={bs}, levels={list(shapes)}, "
              f"d={d}, nq={nq}, P={P}): {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100.0 * bound / ms:.1f} %), plain version {plain:.4f} ms, "
              f"max_abs_err={err:.3e} against it [{card}]")
        del value, loc, wgt, got
        torch.cuda.empty_cache()
    return numbers


def bev2d_path():
    """Phase 12: BEVFormer-2D at BEV2DConfig's defaults over synthetic
    nuScenes scenes, read through NuScenesAdapter from an info pkl under
    TMPDIR and features in an in-memory stand-in for h5py."""
    import pickle
    import tempfile

    import torch

    from vln_ver_tpu_torch.data.nuscenes import (NuScenesAdapter, collate,
                                                 synthetic_nuscenes)
    from vln_ver_tpu_torch.models.bev2d import BEV2DConfig, build_bev2d
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.utils.params import grads_by_name, relu_masks

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = BEV2DConfig()
    scenes = max(BEV2D_BATCHES)
    infos, feats = synthetic_nuscenes(
        scenes, BEV2D_FRAMES, cfg.num_cams, cfg.feat_h, cfg.in_channels,
        seed=3)
    for i, info in enumerate(infos):
        info["can_bus"][-1] = BEV2D_YAW_DEG * (i % BEV2D_FRAMES)
    root = tempfile.mkdtemp(prefix="bev2d_")
    ann = os.path.join(root, "nusc_infos.pkl")
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    data = NuScenesAdapter(ann, root, num_cams=cfg.num_cams,
                           feat_hw=cfg.feat_h)
    store = MemoryH5()
    store.files[data.feature_file] = feats
    with store.installed():
        # every frame read and collated on the host once
        host = {batch: [collate([data[s * BEV2D_FRAMES + t]
                                 for s in range(batch)])
                        for t in range(BEV2D_FRAMES)]
                for batch in BEV2D_BATCHES}
    del store
    shutil.rmtree(root)
    per_frame = 2 * cfg.encoder_layers + cfg.decoder_layers

    def frames(batch, device):
        """Each frame's model inputs at ``batch`` on ``device``."""
        return [[torch.from_numpy(b[k]).to(device) for k in (
            "features", "world2pixel", "origin_shift", "can_bus")]
            for b in host[batch]]

    @torch.inference_mode()
    def chain(model, inputs):
        """Each frame's full forward with the previous frame's bev_embed
        in the TSA queue."""
        prev = None
        for f, w, o, c in inputs:
            outs = model(f, w, o, can_bus=c, prev_bev=prev)
            prev = outs["bev_embed"]
        return outs

    model = off_lattice(build_bev2d(cfg, dev, seed=2))
    cpu_model = off_lattice(build_bev2d(cfg, "cpu", seed=2))
    for batch in BEV2D_BATCHES:
        KERNEL.launches = KERNEL_BWD.launches = 0
        outs = chain(model, frames(batch, dev))
        n = KERNEL.launches
        if n != per_frame * BEV2D_FRAMES or KERNEL_BWD.launches:
            fail(f"BEVFormer2D launched the kernels {n} and "
                 f"{KERNEL_BWD.launches} times over a chain of "
                 f"{BEV2D_FRAMES} frames, expected {per_frame} a frame and "
                 f"none")
        t0 = time.perf_counter()
        ref = chain(cpu_model, frames(batch, "cpu"))
        cpu_s = time.perf_counter() - t0
        for k in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
            err, ok = close(outs[k].detach().cpu(), ref[k].detach(), 1e-4,
                            1e-4)
            print(f"bev2d {k} card vs CPU (batch {batch}, frame "
                  f"{BEV2D_FRAMES} of a prev_bev chain with rotate_prev_bev)"
                  f": max_abs_err={err:.3e} (rtol=1e-4, atol=1e-4) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok or not bool(torch.isfinite(outs[k]).all()):
                fail(f"the BEVFormer2D {k} disagrees with the CPU run")
        print(f"bev2d chain: {batch} x {BEV2D_FRAMES} frames, deform "
              f"launches {n}; the CPU took {cpu_s:.2f}s")

    # one backward of a scalar of the last frame's outputs at batch 1, the
    # card's ReLUs on the CPU run's masks
    masks, res = [], {}
    for m, device in ((cpu_model, "cpu"), (model, dev)):
        m.zero_grad(set_to_none=True)
        inputs = frames(1, device)
        KERNEL.launches = KERNEL_BWD.launches = 0
        cpu = device == "cpu"
        prev = None
        for f, w, o, c in inputs[:-1]:
            with torch.no_grad():
                prev = m(f, w, o, can_bus=c, prev_bev=prev)["bev_embed"]
        f, w, o, c = inputs[-1]
        with relu_masks(m, record=masks if cpu else None,
                        pin=None if cpu else masks):
            outs = m(f, w, o, can_bus=c, prev_bev=prev)
        loss = (outs["all_cls_scores"].square().mean()
                + outs["all_bbox_preds"].square().mean())
        loss.backward()
        res[str(device)] = ({n_: g.cpu() for n_, g in
                             grads_by_name(m).items()},
                            (KERNEL.launches, KERNEL_BWD.launches))
    (gh, _), (gc, (fwd, bwd)) = res["cpu"], res[str(dev)]
    if (fwd, bwd) != (per_frame * BEV2D_FRAMES, per_frame):
        fail(f"the BEVFormer2D backward run launched the kernels {fwd} and "
             f"{bwd} times, expected {per_frame * BEV2D_FRAMES} and "
             f"{per_frame} (history frames launch no backward)")
    worst, failed = (0.0, None), []
    for n_, g_cpu in gh.items():
        diff = float(torch.linalg.vector_norm((gc[n_] - g_cpu).double()))
        norm = float(torch.linalg.vector_norm(g_cpu.double()))
        if diff > 1e-3 * norm + 1e-5 * g_cpu.numel() ** 0.5:
            failed.append(n_)
        if norm > 0 and diff / norm > worst[0]:
            worst = (diff / norm, n_)
    print(f"bev2d gradients card vs CPU (batch 1, a scalar of frame "
          f"{BEV2D_FRAMES}'s outputs, history frames without gradients): "
          f"{len(gh)} parameters, worst relative L2 difference "
          f"{worst[0]:.3e} ({worst[1]}) (within 1e-3 relative + 1e-5 x "
          f"sqrt(n)), deform launches {fwd} forward + {bwd} backward "
          f"{'ok' if not failed else 'FAIL ' + str(failed[:5])}")
    if failed:
        fail(f"BEVFormer2D card gradients disagree with the CPU: "
             f"{failed[:5]}")
    print(f"bev2d phase: {time.perf_counter() - t_phase:.2f}s")


def visibility_flips(cfg, w2p, shift):
    """(nq,) bool: the voxel queries whose visibility in some camera of
    the first viewpoint differs between the card's and the CPU's fp32
    projection (``geometry.project_reference_points``, as the lift runs
    it)."""
    import torch

    from vln_ver_tpu_torch.geometry import (project_reference_points,
                                            voxel_reference_points)
    from vln_ver_tpu_torch.runtime import fp32_precision
    masks = []
    for dev in ("cuda", "cpu"):
        with fp32_precision(torch.float32):
            masks.append(project_reference_points(
                voxel_reference_points(cfg.bev_z, cfg.bev_h, cfg.bev_w,
                                       device=dev),
                torch.from_numpy(w2p).to(dev),
                torch.from_numpy(shift).to(dev),
                pc_range=cfg.pc_range)[1].cpu())
    return (masks[0] != masks[1]).any(dim=-2)[0]


def headline_path(card):
    """Phase 13: the 36-view headline (``vln_ver_tpu_torch.bench``), then
    ``check_determinism`` at its defaults.  Returns its numbers."""
    import torch

    from vln_ver_tpu_torch import bench, check_determinism
    from vln_ver_tpu_torch.models import VERConfig, VoxelFormer, build_model
    from vln_ver_tpu_torch.models.head import upsampler_stages
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.ops.occ_mlp import KERNEL as OCC
    from vln_ver_tpu_torch.ops.up_assemble import KERNEL as UP

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    base = VERConfig(num_cams=HEADLINE_CAMS, dtype=torch.bfloat16)
    stages = upsampler_stages(base)
    feats, w2p, shift = bench.example_inputs(base, batch=HEADLINE_BATCH)
    qcap = bench.derived_qcap(base, w2p, shift)
    print(f"headline: the rig's derived capacity {qcap} "
          f"(expected {HEADLINE_QCAP})")
    if qcap != HEADLINE_QCAP:
        fail(f"derived capacity {qcap}, expected {HEADLINE_QCAP}")
    # seed-0 weights drawn once on the CPU; every model below loads them
    cpu_model = build_model(dataclasses.replace(
        base, dtype=torch.float32, sca_query_capacity=qcap), "cpu", seed=0)
    weights = cpu_model.state_dict()
    ins = [torch.from_numpy(a).to(dev) for a in (feats, w2p, shift)]

    def on_card(dtype, cap):
        model = VoxelFormer(dataclasses.replace(
            base, dtype=dtype, sca_query_capacity=cap))
        model.load_state_dict(weights)
        return model.to(dev).eval()

    heads = ("bev_embed", "occupancy_preds", "all_cls_scores",
             "all_bbox_preds")
    for cap in (qcap, 0):
        model = on_card(torch.bfloat16, cap)
        KERNEL.launches = KERNEL_BWD.launches = OCC.launches = 0
        UP.launches = 0
        with torch.inference_mode(), planned() as nq:
            outs = model(*ins)
            torch.cuda.synchronize()
        got = (KERNEL.launches, KERNEL_BWD.launches, nq["fwd"],
               OCC.launches, UP.launches)
        want = (model.cfg.encoder_layers, 0, cap or model.cfg.bev_num, 2,
                stages)
        overflow = int(outs["sca_overflow"])
        bad = [k for k in heads if not bool(torch.isfinite(
            outs[k].float()).all())]
        print(f"headline bf16 forward at batch {HEADLINE_BATCH}, capacity "
              f"{cap}: (forward, backward launches, nq, occupancy MLP, "
              f"upsampler assembly launches) {got}, expected {want}; "
              f"sca_overflow {overflow}; "
              f"non-finite {bad}; shapes "
              f"{[tuple(outs[k].shape) for k in heads]}")
        if got != want or overflow or bad:
            fail(f"the 36-view forward at capacity {cap}")
        del outs, model
    # the sparse lift against the dense one in fp32, and against the CPU
    bevs = {}
    for cap in (0, qcap):
        model = on_card(torch.float32, cap)
        with torch.inference_mode():
            bevs[cap] = model(*ins, only_bev=True)["bev_embed"]
    err = float((bevs[qcap] - bevs[0]).abs().max())
    print(f"headline fp32 bev_embed at batch {HEADLINE_BATCH}, sparse "
          f"(capacity {qcap}) vs dense: max_abs_err={err:.3e} (atol 1e-5) "
          f"{'ok' if err <= 1e-5 else 'FAIL'}")
    if err > 1e-5:
        fail("the sparse 36-view lift disagrees with the dense one")
    with torch.inference_mode():
        card1 = model(*[t[:1] for t in ins], only_bev=True)["bev_embed"]
        cpu1 = cpu_model(*[torch.from_numpy(a[:1])
                           for a in (feats, w2p, shift)],
                         only_bev=True)["bev_embed"]
    # this rig puts voxel centres on image edges (0.0 from an edge in
    # float64): there the fp32 visibility test may differ in its last bit
    # between the card and the CPU, and the query then averages over
    # another set of cameras.  Such queries are counted, and every other
    # query is held.
    flipped = visibility_flips(base, w2p[:1], shift[:1])
    cpu_err, ok = close(card1.cpu()[:, ~flipped], cpu1[:, ~flipped], 1e-4,
                        1e-4)
    flip_err = float((card1.cpu() - cpu1).abs().max())
    print(f"headline fp32 bev_embed at batch 1, card vs CPU: "
          f"max_abs_err={cpu_err:.3e} (rtol=1e-4, atol=1e-4) over the "
          f"{int((~flipped).sum())} queries whose visibility both devices "
          f"agree on {'ok' if ok else 'FAIL'}; {int(flipped.sum())} queries "
          f"see another set of cameras on the card (max_abs_err "
          f"{flip_err:.3e} with them)")
    if not ok:
        fail("the 36-view card bev_embed disagrees with the CPU run")
    del model, bevs, cpu_model, weights, card1, cpu1
    torch.cuda.empty_cache()

    KERNEL.launches = KERNEL_BWD.launches = OCC.launches = UP.launches = 0
    det = check_determinism.run(check_determinism.parse_args([]))
    runs = len(det["prints"])
    got = (KERNEL.launches, KERNEL_BWD.launches, OCC.launches, UP.launches)
    each = (base.encoder_layers, 0, 2, stages)
    if got != tuple(runs * n for n in each):
        fail(f"check_determinism launched (forward, backward, occupancy "
             f"MLP, upsampler assembly) {got}, expected {each} x {runs} "
             f"runs")
    print(f"check_determinism (36 cameras, bf16, batch 2, {runs} runs): "
          f"bitwise deterministic {det['bitwise_deterministic']}, outputs "
          f"that differ {det['differs']}, launches (forward, backward, "
          f"occupancy MLP, upsampler assembly) {got} [{card}]")
    torch.cuda.empty_cache()
    headline_train_and_dump(base, qcap, w2p, shift, dev)
    print(f"headline phase: {time.perf_counter() - t_phase:.2f}s")
    return dict(determinism={k: det[k] for k in ("bitwise_deterministic",
                                                 "differs")},
                sparse_vs_dense_err=err, card_vs_cpu_err=cpu_err,
                visibility_flips=int(flipped.sum()))


def headline_train_and_dump(base, qcap, w2p, shift, dev):
    """Phase 13's untimed runs of the 36-view bf16 paths that nothing else
    drives on the card: one train step of ``base`` at batch 2 (dense lift,
    ``bench_train``'s synthetic batch), which must launch each deform
    kernel once a layer, never the occupancy MLP or the upsampler's
    assembly kernel (autograd on), and give a finite loss; then the ViT ->
    lift dump (``make_bev_only`` with a bf16 ViT-B/16 through
    ``dump_volumes`` into ``verbench.h5mem``) of two batches of viewpoints
    at the rig's capacity ``qcap``, which must write each volume finite
    with no overflow, launch the forward kernel once a layer a batch and
    nothing else."""
    import torch

    from vln_ver_tpu_torch.bench_train import synthetic_batch
    from vln_ver_tpu_torch.get_occ import make_bev_only
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.models.vit import vit_for_ver
    from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, KERNEL_BWD
    from vln_ver_tpu_torch.ops.occ_mlp import KERNEL as OCC
    from vln_ver_tpu_torch.ops.up_assemble import KERNEL as UP
    from vln_ver_tpu_torch.train.feed import to_device
    from vln_ver_tpu_torch.train.state import TrainConfig, create_train_state
    from vln_ver_tpu_torch.train.step import make_train_step
    from vln_ver_tpu_torch.ver_writer import dump_volumes

    layers = base.encoder_layers
    tc = TrainConfig(warmup_steps=10, total_steps=1000)
    state = create_train_state(build_model(base, dev, seed=0), tc)
    batch = to_device(synthetic_batch(base, 2, 16), dev)
    KERNEL.launches = KERNEL_BWD.launches = OCC.launches = UP.launches = 0
    loss = float(make_train_step(base, tc)(state, batch, 1)["loss"])
    got = (KERNEL.launches, KERNEL_BWD.launches, OCC.launches, UP.launches)
    print(f"headline bf16 train step at batch 2: loss {loss:.4f}, launches "
          f"(forward, backward, occupancy MLP, upsampler assembly) {got}, "
          f"expected {(layers, layers, 0, 0)}")
    if got != (layers, layers, 0, 0) or not math.isfinite(loss):
        fail("the 36-view bf16 train step")
    del state, batch
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(base, sca_query_capacity=qcap)
    model = build_model(cfg, dev, seed=0).eval()
    vit = vit_for_ver(cfg, dtype=torch.bfloat16)
    vit.init_weights(torch.Generator().manual_seed(1))
    vit = vit.to(dev).eval()
    n = 2 * len(w2p)
    size = vit.image_size
    images = np.random.default_rng(6).integers(
        0, 256, (n, cfg.num_cams, size, size, 3)).astype(np.uint8)
    dataset = [dict(images=images[i], world2pixel=w2p[i % len(w2p)],
                    origin_shift=shift[i % len(w2p)], token=f"vp{i:02d}")
               for i in range(n)]
    store = MemoryH5()
    store.keep = {d["token"] for d in dataset}
    KERNEL.launches = KERNEL_BWD.launches = OCC.launches = UP.launches = 0
    with store.installed():
        res = dump_volumes(make_bev_only(model, vit), dataset, cfg,
                           "headline_images.hdf5", batch_size=len(w2p),
                           device=dev, input_key="images")
    got = (KERNEL.launches, KERNEL_BWD.launches, OCC.launches, UP.launches)
    bad = [k for k, v in store.kept.items() if not np.isfinite(v).all()]
    print(f"headline bf16 ViT -> lift dump of {n} viewpoints at batch "
          f"{len(w2p)}: {res['written']} volumes written, sca_overflow "
          f"{res['sca_overflow']}, non-finite {bad}, launches (forward, "
          f"backward, occupancy MLP, upsampler assembly) {got}, expected "
          f"{(2 * layers, 0, 0, 0)}")
    if (res["written"] != n or len(store.kept) != n or res["sca_overflow"]
            or bad or got != (2 * layers, 0, 0, 0)):
        fail("the 36-view bf16 image dump")
    del model, vit, store
    torch.cuda.empty_cache()


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
    checks = [  # (name, bs, H, W, d, nq, dtype, loc range[, P])
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
    ] + [(f"{name} P={pp} {'fp32' if dt is f32 else 'bf16'}", bs, H, W, dd,
          nq, dt, (-0.1, 1.1), pp)
         for name, bs, H, W, dd, nq, pp in PATH_SHAPES
         for dt in (f32, bf16)]
    # phase 13's launches: both kernels at 72 slots, the forward alone at
    # 288 (inference has no backward)
    def headline(backward):
        return [(f"{name} {'fp32' if dt is f32 else 'bf16'}", bs, 14, 14, 96,
                 nq, dt, (-0.1, 1.1))
                for name, bs, nq, bwd in HEADLINE_SHAPES if bwd == backward
                for dt in (f32, bf16)]
    checks += headline(True)
    forward_only = headline(False)
    tolerance = {f32: (1e-4, 1e-5), bf16: (1e-2, 1e-2)}
    main_err = None
    with torch.inference_mode():
        for i, (name, bs, H, W, dd, nq, dt, rng_, *pp) in enumerate(
                checks + forward_only):
            rtol, atol = tolerance[dt]
            v, loc, w = deform_inputs(bs, H * W, heads, dd, nq, *(pp or [P]),
                                      dt, i, dev, *rng_)
            got = KERNEL(v, ((H, W),), loc, w)
            torch.cuda.synchronize()
            ref = plain_forward(v, (H, W), loc, w)
            torch.cuda.synchronize()
            err, ok = close(got.float(), ref, rtol, atol)
            plan = KERNEL.plan(bs, heads, nq, H * W, dd, v.element_size(),
                               dev)
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
    for i, (name, bs, H, W, dd, nq, dt, rng_, *pp) in enumerate(checks):
        v, loc, w = deform_inputs(bs, H * W, heads, dd, nq, *(pp or [P]), dt,
                                  i, dev, *rng_)
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
        plan = KERNEL_BWD.plan(bs, heads, nq, H * W, dd, v.element_size(),
                               dev, True, True)
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

    KERNEL.launches = KERNEL_BWD.launches = 0
    vols, bevs = run_main_path()
    launches, bwd_launches = KERNEL.launches, KERNEL_BWD.launches
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
    print(f"main path: {N_VIEWPOINTS} volumes of {shape} at batch {BATCH}, "
          f"deform launches {launches}")

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
    dense_vols = np.concatenate(vols)

    # -- phase 4b-4d: the sparse lift, the int8 upload, the image path ----
    extra = sparse_lift(model, ver, feats, w2p, shift, dense_vols, card)
    # the seed-0 weights, kept for phase 10c's models
    seed0_weights = cpu_model.state_dict()
    extra["int8_max_dev_from_fp32"] = int8_upload(
        model, cpu_model, ver, feats, w2p, shift, dense_vols)
    del cpu_model
    images, image_vols = image_path(model, ver, w2p, shift)

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
                plans[name] = KERNEL.plan(bs, heads, nq, H * W, d,
                                          v.element_size(), dev)._asdict()
                bound_ms, bound_by = deform_bound(v, loc, (H, W))
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
            plan = KERNEL_BWD.plan(bs, heads, nq, H * W, d, v.element_size(),
                                   dev, True, True)
            bwd_plans[name] = plan._asdict()
            bound_ms, bound_by = deform_bound(v, loc, (H, W), backward=True)
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
    path_timing = path_shape_timing(card)
    headline_timing = headline_shape_timing(card)

    # -- phase 5b: the upsampler's factorised route vs the dense one -------
    print(json.dumps({"upsampler": {**upsampler_routes(card),
                                    "card": card}}))

    # -- phase 5c: the occupancy MLP kernel vs the eager chain -------------
    occ_mlp = occ_mlp_shapes(card)
    print(json.dumps({"occ_mlp": {**occ_mlp, "card": card}}))

    # -- phase 5d: the upsampler's assembly kernel vs the plain assembly ---
    print(json.dumps({"up_assemble": {**up_assemble_shapes(card),
                                      "card": card}}))

    # -- phase 6: full forward and eval ------------------------------------
    samples = full_forward_and_eval(model, ver)
    del model

    # -- phase 7: training -------------------------------------------------
    training(ver, samples, card)

    # -- phase 8: VER volumes -> the VLN agent's greedy evaluation ---------
    agent, agent_env = agent_path(ver)
    print(json.dumps({"agent": {**agent, "card": card}}))

    # -- phase 9: the agent's training on phase 8's volumes -----------------
    agent_train = agent_training(*agent_env, card)
    print(json.dumps({"agent_train": {**agent_train, "card": card}}))

    # -- phase 10: the server on the card ----------------------------------
    serving(ver, feats, w2p, shift, dense_vols, images, image_vols, samples)

    # -- phase 10b: NCCL of world 1: mesh dumps, train, eval, agent eval ---
    mesh_world_one(ver, feats, w2p, shift, dense_vols, samples, agent_env,
                   card)

    # -- phase 10c: NCCL of world 1: TP and multi-slice steps, pipeline ---
    grid_numbers = grids_world_one(ver, seed0_weights, samples, card)
    del seed0_weights
    print(json.dumps({"grids": {**grid_numbers, "card": card}}))

    # -- phase 11: temporal VER (TSA) and decoder_on_bev -------------------
    temporal_path(ver, samples, card)

    # -- phase 12: BEVFormer-2D over synthetic nuScenes scenes -------------
    bev2d_path()
    print(json.dumps({"gather": {**gather_shapes(card), "card": card}}))

    # -- phase 13: the 36-view headline and check_determinism --------------
    print(json.dumps({"headline": headline_path(card)}))

    ms, eager_ms, plain_ms, bound_ms, bound_by, floor_ms = timing[
        "B=1 float32"]
    ms4, eager_ms4, plain_ms4, bound_ms4, _, floor_ms4 = timing[
        "B=4 float32"]
    print(json.dumps({"kernels": [{
        "name": "deform_attn_2d",
        "route": "cuda",
        "source": "vln_ver_tpu_torch/csrc/deform_attn_2d.cu",
        "replaces": "vln_ver_tpu/ops/pallas_deform.py:38",
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
        "path_shapes": {k: {n: v for n, v in r.items()
                            if not n.startswith("bwd_")}
                        for k, r in path_timing.items()},
        "headline_shapes": {k: {n: v for n, v in r.items()
                                if not n.startswith("bwd_")}
                            for k, r in headline_timing.items()},
        "card": card,
    }, {
        "name": "deform_attn_2d_backward",
        "route": "cuda",
        "source": "vln_ver_tpu_torch/csrc/deform_attn_2d_bwd.cu",
        "replaces": "vln_ver_tpu/ops/pallas_deform.py:237",
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
        "path_shapes": {k: {n[4:]: v for n, v in r.items()
                            if n.startswith("bwd_")}
                        for k, r in path_timing.items()},
        "headline_shapes": {k: {n[4:]: v for n, v in r.items()
                                if n.startswith("bwd_")}
                            for k, r in headline_timing.items()
                            if "bwd_ms" in r},
        "card": card,
    }, {
        "name": "occ_mlp",
        "route": "cuda",
        "source": "vln_ver_tpu_torch/csrc/occ_mlp.cu",
        "replaces": None,
        "max_abs_err": occ_mlp["B=1"]["max_abs_err"],
        "ms": occ_mlp["B=1"]["ms"],
        "bound_ms": occ_mlp["B=1"]["bound_ms"],
        "bound_share": occ_mlp["B=1"]["bound_ms"] / occ_mlp["B=1"]["ms"],
        "eager_ms": occ_mlp["B=1"]["eager_ms"],
        "max_abs_err_b8": occ_mlp["B=8"]["max_abs_err"],
        "ms_b8": occ_mlp["B=8"]["ms"],
        "bound_ms_b8": occ_mlp["B=8"]["bound_ms"],
        "eager_ms_b8": occ_mlp["B=8"]["eager_ms"],
        "card": card,
    }]}))
    print(f"chip_smoke total: {time.perf_counter() - T_START:.2f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
