"""The port's headline measurement (``vln_ver_tpu_torch/bench.py``), its
timing harness (``utils/bench.py``) and the throughput CLIs
(``benchmark``, ``bench_train``) against the JAX package and the root
``bench.py``, on the CPU: the derived capacity and the example inputs,
the full-forward step on converted weights, the harness's keys, and the
bench line's keys on a tiny configuration."""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import JCFG, TCFG, jax_params, port_model

import __graft_entry__
import bench as jax_bench
from vln_ver_tpu.models import VERConfig as JaxVERConfig
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu_torch import bench, bench_train, benchmark
from vln_ver_tpu_torch.models import VERConfig
from vln_ver_tpu_torch.utils.bench import (event_time, event_time_stats,
                                           full_forward_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
# bench.py's line less vs_baseline (its baselines are TPU readings), plus
# the card and the peak memory
LINE_KEYS = {"metric", "value", "unit", "batch", "qcap", "spread",
             "value_batch1", "e2e_volumes_per_sec", "e2e_rates",
             "e2e_spread", "e2e_upload", "e2e_from_images",
             "e2e_from_images_rates", "card", "peak_mib"}
# 36 cameras at tiny widths (the ViT's 12 heads divide 48 channels)
TINY36 = VERConfig(num_cams=36, dtype=torch.float32, bev_z=2, bev_h=4,
                   bev_w=4, occupancy_size=(1.5, 1.5, 0.4375), feat_h=4,
                   feat_w=4, embed_dims=48, in_channels=48, ffn_dim=64,
                   occ_dims=16, encoder_layers=1, decoder_layers=2,
                   num_query=12, num_heads=4)


def test_derived_capacity_equals_the_root_bench_on_the_36_camera_rig():
    jcfg = JaxVERConfig(num_cams=36, dtype=jnp.bfloat16)
    _, w2p, shift = __graft_entry__._example_inputs(jcfg, batch=8)
    want = jax_bench._derived_qcap(jcfg, w2p, shift)
    _, w2p_t, shift_t = bench.example_inputs(
        VERConfig(num_cams=36, dtype=torch.bfloat16), batch=8)
    got = bench.derived_qcap(VERConfig(num_cams=36), w2p_t, shift_t)
    assert got == want == 192


@pytest.mark.parametrize("cfgs,batch,seed", [
    ((JaxVERConfig(num_cams=36), VERConfig(num_cams=36)), 2, 0),
    ((JCFG, TCFG), 3, 5)])
def test_example_inputs_equal_the_jax_entry_bitwise(cfgs, batch, seed):
    want = __graft_entry__._example_inputs(cfgs[0], batch=batch, seed=seed)
    got = bench.example_inputs(cfgs[1], batch=batch, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_forward_step_equals_the_sum_of_jax_outputs():
    """``full_forward_step`` reduces every head output: on converted
    weights it is JAX's four outputs summed in fp32 (rtol 1e-4, atol
    5e-5, the full forward's bound)."""
    params = jax_params(JCFG)
    feats, w2p, shift = bench.example_inputs(TCFG, batch=2)
    outs = jax.jit(JaxVoxelFormer(JCFG).apply)(
        {"params": params}, *map(jnp.asarray, (feats, w2p, shift)))
    keys = ("bev_embed", "occupancy_preds", "all_cls_scores",
            "all_bbox_preds")
    want = sum(float(jnp.sum(outs[k].astype(jnp.float32))) for k in keys)
    step = full_forward_step(port_model(params, TCFG))
    got = step(*map(torch.from_numpy, (feats, w2p, shift)))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-4, atol=5e-5)
    only = full_forward_step(port_model(params, TCFG), only_bev=True)(
        *map(torch.from_numpy, (feats, w2p, shift)))
    np.testing.assert_allclose(
        float(only), float(jnp.sum(outs["bev_embed"])), rtol=1e-4,
        atol=5e-5)


def test_harness_returns_the_jax_keys():
    calls = []
    stats = event_time_stats(lambda: calls.append(1) or torch.ones(4),
                             "cpu", iters=3, warmup=2, repeats=4)
    assert set(stats) == {"sec_per_iter", "sec_per_iter_med", "spread",
                          "samples", "calls"}
    assert len(stats["samples"]) == 4 and stats["spread"] >= 0
    assert stats["sec_per_iter"] == min(stats["samples"]) > 0
    assert stats["sec_per_iter"] <= stats["sec_per_iter_med"]
    assert stats["calls"] == len(calls) == 2 + 3 * 4
    assert event_time(lambda: torch.ones(2), "cpu", iters=1) > 0
    with pytest.raises(ValueError):
        event_time_stats(lambda: None, "meta", iters=1)


def test_bench_line_on_a_tiny_config(tmp_path, capsys):
    line = bench.main(["--device", "cpu", "--batch", "2", "--alt-batch", "1",
                       "--iters", "1", "--repeats", "2", "--e2e-volumes", "2",
                       "--e2e-passes", "1", "--data-dir", str(tmp_path)],
                      base=TINY36)
    assert set(line) == LINE_KEYS
    assert line["metric"] == "ver_volumes_per_sec_per_chip_36view"
    assert line["qcap"] == TINY36.bev_num and line["card"] == "cpu"
    assert all(line[k] > 0 for k in ("value", "value_batch1",
                                     "e2e_volumes_per_sec",
                                     "e2e_from_images"))
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == line


def test_bench_refuses_e2e_without_h5py(monkeypatch, tmp_path):
    import sys
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(SystemExit, match="--no-e2e"):
        bench.main(["--device", "cpu", "--data-dir", str(tmp_path)],
                   base=TINY36)


def test_benchmark_cli_prints_the_tool_lines(capsys):
    out = benchmark.main([CONFIG, "--device", "cpu", "--iters", "1",
                          "--warmup", "0", "--mode", "bev",
                          "--batch-size", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device=cpu cams=2 batch=2 mode=bev dtype=float32"
    assert lines[1].startswith("throughput: ") and lines[2] == "card: cpu"
    assert out["samples_per_sec"] > 0


@pytest.mark.parametrize("mode", ["step", "grad", "fwd"])
def test_bench_train_modes_on_the_tiny_model(mode):
    line = bench_train.run(bench_train.parse_args(
        ["--tiny", "--cams", "2", "--iters", "1", "--mode", mode,
         "--device", "cpu"]))
    assert line["metric"] == "train_step_seconds" and line["mode"] == mode
    assert line["value"] > 0 and math.isfinite(line["last_loss"])
    assert line["steps_run"] == 2 + 3


def test_bench_train_batch_is_the_jax_tools():
    """The synthetic batch of tools/bench_train.py:186-222, array for
    array (draws of numpy seed 0 after the example inputs)."""
    cfg = bench_train.model_config(bench_train.parse_args(["--tiny"]))
    got = bench_train.synthetic_batch(cfg, 2, 16)
    rng = np.random.default_rng(0)
    boxes = np.zeros((2, 16, 9), np.float32)
    boxes[:, :, 3:6] = 1.0
    boxes[:, :, 0:2] = rng.uniform(-4, 4, (2, 16, 2))
    np.testing.assert_array_equal(got["gt_boxes"], boxes)
    np.testing.assert_array_equal(got["gt_labels"], rng.integers(
        0, cfg.num_classes, (2, 16)).astype(np.int32))
    np.testing.assert_array_equal(got["gt_valid"],
                                  rng.uniform(size=(2, 16)) < 0.6)
    np.testing.assert_array_equal(got["occ_dense"], rng.integers(
        0, cfg.occupancy_classes + 1, (2, cfg.voxel_num)).astype(np.int32))
    jcfg = JaxVERConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name != "dtype"})
    for g, w in zip((got["features"], got["world2pixel"],
                     got["origin_shift"]),
                    __graft_entry__._example_inputs(jcfg, batch=2)):
        np.testing.assert_array_equal(g, np.asarray(w))
