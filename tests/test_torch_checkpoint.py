"""The port's train checkpoints and its train CLI on the CPU: save and
restore, the completed-step scan, the background saver, a reference-format
model file, ``python -m vln_ver_tpu_torch.train`` on the tiny config
(falling losses, a checkpoint, ``--resume`` at the right step and data
position, SIGTERM, the refusals), and ``python -m vln_ver_tpu_torch.test
--checkpoint`` on a train checkpoint directory."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vln_ver_tpu_torch import test as test_cli
from vln_ver_tpu_torch.convert import load_checkpoint
from vln_ver_tpu_torch.convert import voxelformer as convert
from vln_ver_tpu_torch.models import VERConfig
from vln_ver_tpu_torch.models.detector import build_model
from vln_ver_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_train_step)
from vln_ver_tpu_torch.train.cli import main as train_main
from vln_ver_tpu_torch.utils.checkpoint import (AsyncSaver, latest_step,
                                                load_model, model_file,
                                                restore_state, save_model,
                                                save_state, step_dir)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
CFG = VERConfig(num_cams=2, feat_h=4, feat_w=4, in_channels=32,
                embed_dims=32, num_heads=4, encoder_layers=1,
                decoder_layers=2, ffn_dim=64, num_query=8, num_classes=3,
                occupancy_classes=4, occ_dims=8, bev_z=2, bev_h=4, bev_w=4,
                occupancy_size=(1.5, 1.5, 0.875), refine_occ=True)


def _batch(seed, bs=2):
    rng = np.random.default_rng(seed)
    from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel
    w2p = np.stack([np.stack([make_pinhole_world2pixel(90.0, d, [0, 0, 1])
                              for d in (0.0, 180.0)])] * bs)
    gt = np.concatenate([rng.uniform(-2, 2, (bs, 3, 3)),
                         rng.uniform(0.3, 2, (bs, 3, 3)),
                         rng.uniform(-3, 3, (bs, 3, 1)),
                         np.zeros((bs, 3, 2))], -1)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        features=rng.standard_normal((bs, 2, 4, 4, 32)).astype(np.float32),
        world2pixel=w2p.astype(np.float32),
        origin_shift=np.zeros((bs, 3), np.float32),
        gt_boxes=gt.astype(np.float32),
        gt_labels=rng.integers(0, 3, (bs, 3)),
        gt_valid=np.ones((bs, 3), bool),
        occ_dense=rng.integers(0, 5, (bs, CFG.voxel_num))).items()}


def _trained(steps=2, seed=0):
    state = create_train_state(build_model(CFG, "cpu", seed=seed),
                               TrainConfig(warmup_steps=1, total_steps=10))
    step = make_train_step(CFG, state.tc)
    for i in range(steps):
        step(state, _batch(i), seed=0)
    return state, step


def _same_state(a, b):
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    assert a.step == b.step


def test_save_restore_round_trip(tmp_path):
    state, step = _trained()
    path = save_state(str(tmp_path), state.step, state)
    assert path == step_dir(str(tmp_path), 2) and os.path.isdir(path)
    fresh = create_train_state(build_model(CFG, "cpu", seed=5), state.tc)
    restore_state(str(tmp_path), latest_step(str(tmp_path)), fresh)
    _same_state(state, fresh)
    # the next step is the same on both
    a = step(state, _batch(7), seed=0)
    b = step(fresh, _batch(7), seed=0)
    assert float(a["loss"]) == float(b["loss"])
    _same_state(state, fresh)


def test_model_file_is_a_reference_state_dict(tmp_path):
    state, _ = _trained(1)
    save_state(str(tmp_path), 1, state)
    model = build_model(CFG, "cpu", seed=9)
    assert model_file(str(tmp_path)) == os.path.join(
        step_dir(str(tmp_path), 1), "model.pth")
    load_checkpoint(model, model_file(str(tmp_path)))
    for (n, p), (_, q) in zip(model.named_parameters(),
                              state.model.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    with pytest.raises(FileNotFoundError):
        model_file(str(tmp_path / "nothing"))


def test_model_only_checkpoint_round_trip(tmp_path):
    """save_model writes the step directory with model.pth alone (the VLN
    policy's checkpoint); load_model reads it back strictly from the
    checkpoint directory, the step directory or the file."""
    from vln_ver_tpu_torch.agent.policy import PolicyConfig, build_policy
    cfg = PolicyConfig(embed_dims=16, num_heads=2, fusion_layers=1,
                       text_layers=1, ffn_dim=32, vocab_size=20,
                       max_text_len=8, max_nodes=4, bev_z=1, bev_h=2,
                       bev_w=2, num_query_tokens=1)
    saved = build_policy(cfg, "cpu", seed=1)
    ckpt = str(tmp_path / "ckpt")
    path = save_model(ckpt, 5, saved)
    assert path == step_dir(ckpt, 5) and os.listdir(path) == ["model.pth"]
    assert latest_step(ckpt) == 5
    for where in (ckpt, path, os.path.join(path, "model.pth")):
        fresh = load_model(where, build_policy(cfg, "cpu", seed=2))
        for (n, p), q in zip(fresh.state_dict().items(),
                             saved.state_dict().values()):
            assert torch.equal(p, q), n
    other = build_policy(PolicyConfig(**{**cfg.__dict__, "ffn_dim": 16}),
                         "cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_model(ckpt, other)


def test_latest_step_skips_temporary_and_stray_entries(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    assert latest_step(str(tmp_path)) is None
    os.makedirs(tmp_path / "step_00000003")
    os.makedirs(tmp_path / "step_00000007.tmp-123-456")   # a write in flight
    (tmp_path / "step_00000009").write_text("not a directory")
    os.makedirs(tmp_path / "step_12")                      # 12 > 3, a step
    assert latest_step(str(tmp_path)) == 12
    with pytest.raises(FileNotFoundError, match="no completed"):
        restore_state(str(tmp_path), None, None)


def test_async_saver_snapshots_at_save_and_waits(tmp_path):
    state, _ = _trained(1)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    with AsyncSaver() as saver:
        path = saver.save(str(tmp_path), 1, state)
        with torch.no_grad():           # the next step's in-place update
            for p in state.model.parameters():
                p.add_(1.0)
    assert os.path.isdir(path) and latest_step(str(tmp_path)) == 1
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]
    saved = torch.load(os.path.join(path, "model.pth"), weights_only=True)
    for n, p in before.items():
        torch.testing.assert_close(saved[n], p, rtol=0, atol=0, msg=n)


def test_train_state_from_jax_needs_an_adam_state():
    with pytest.raises(ValueError, match="AdamW"):
        convert.train_state_from_jax({}, (), CFG)


# ---- the CLIs ---------------------------------------------------------------

def _log(wd):
    with open(os.path.join(wd, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_drive_then_eval_from_its_checkpoint(tmp_path, monkeypatch):
    """Four steps over the whole synthetic split (batch 8) at lr 1e-3:
    finite losses that fall, a checkpoint and meta.json; then the eval CLI
    reads the checkpoint directory's latest step."""
    monkeypatch.chdir(tmp_path)
    metrics = train_main([CONFIG, "--device", "cpu", "--synthetic",
                          "--max-steps", "4", "--batch-size", "8",
                          "--log-interval", "1", "--work-dir", "wd",
                          "--cfg-options", "optimizer.lr=0.001"])
    log = _log("wd")
    assert [m["step"] for m in log] == [1, 2, 3, 4]
    losses = [m["loss"] for m in log]
    assert all(np.isfinite(m[k]) for m in log for k in m)
    assert losses[-1] < losses[0], losses
    assert {"lr", "sec_per_step", "grad_norm", "loss_occupancy",
            "d0.loss_cls"} <= set(log[0])
    assert metrics["step"] == 4 and latest_step("wd/ckpt") == 4
    meta = json.load(open("wd/ckpt/meta.json"))
    assert "model" in meta["config"] and meta["CLASSES"]

    loaded = []
    monkeypatch.setattr(convert, "load_checkpoint",
                        lambda m, p: loaded.append(p) or load_checkpoint(m, p))
    out = test_cli.main([CONFIG, "--device", "cpu", "--synthetic",
                         "--limit", "2", "--checkpoint", "wd/ckpt"])
    assert loaded == [os.path.join(step_dir("wd/ckpt", 4), "model.pth")]
    assert {"miou", "iou", "mAP_0.25"} <= set(out)


def test_train_cli_resume_continues_step_and_data_order(tmp_path,
                                                        monkeypatch):
    """Stopping after step 3 (mid-epoch: batch 2, 4 steps an epoch) and
    resuming to step 6 takes the same batches, with the same dropout
    draws, as one run of 6 steps: the same losses."""
    monkeypatch.chdir(tmp_path)
    base = [CONFIG, "--device", "cpu", "--synthetic", "--batch-size", "2",
            "--log-interval", "1"]
    train_main(base + ["--work-dir", "full", "--max-steps", "6"])
    train_main(base + ["--work-dir", "part", "--max-steps", "3",
                       "--ckpt-interval", "2", "--async-ckpt"])
    assert latest_step("part/ckpt") == 3
    train_main(base + ["--work-dir", "part", "--max-steps", "6",
                       "--resume"])
    full, part = _log("full"), _log("part")
    assert [m["step"] for m in part] == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose([m["loss"] for m in part],
                               [m["loss"] for m in full], rtol=1e-6)
    assert latest_step("part/ckpt") == 6


def test_train_cli_eval_ticks_and_save_best(tmp_path, monkeypatch):
    """With a val split on disk, ``--eval-interval 2`` evaluates at steps 2
    and 4 through ``evaluate_model`` (the model back in ``train()``
    after), logs the metrics and keeps the best under ``ckpt_best/``."""
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.data import make_synthetic_dataset
    monkeypatch.chdir(tmp_path)
    ver = build_ver_config(load_config(CONFIG))
    make_synthetic_dataset("data/tiny", split="test", num_cams=ver.num_cams,
                           feat_hw=ver.feat_h, feat_dim=ver.in_channels,
                           occ_dims=(ver.occ_zdim, ver.occ_ydim,
                                     ver.occ_xdim), pc_range=ver.pc_range)
    train_main([CONFIG, "--device", "cpu", "--synthetic", "--max-steps",
                "4", "--eval-interval", "2", "--eval-limit", "2",
                "--save-best", "iou", "--occ-thresholds", "0.02",
                "--work-dir", "wd"])
    evals = [m for m in _log("wd") if "iou" in m]
    assert [m["step"] for m in evals] == [2, 4]
    assert {"miou", "occ_precision", "mAP_0.25"} <= set(evals[0])
    best = latest_step("wd/ckpt_best")
    assert best in (2, 4)
    assert max(m["iou"] for m in evals) == next(
        m["iou"] for m in evals if m["step"] == best)


def test_train_cli_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # a mesh the world (one process) cannot hold
    with pytest.raises(ValueError, match="needs 2 processes"):
        train_main([CONFIG, "--device", "cpu", "--mesh", "2,1"])
    with pytest.raises(NotImplementedError, match="item 13b"):
        train_main([CONFIG, "--device", "cpu", "--tp-model", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main([CONFIG, "--synthetic"])


def test_sigterm_checkpoints_and_exits_zero(tmp_path):
    """As tests/test_preempt_train.py for the JAX CLI: SIGTERM mid-run
    finishes the step, writes a checkpoint of it and exits 0."""
    wd = str(tmp_path / "wd")
    p = subprocess.Popen(
        [sys.executable, "-m", "vln_ver_tpu_torch.train", CONFIG, "--device",
         "cpu", "--synthetic", "--max-steps", "100000", "--log-interval",
         "1", "--ckpt-interval", "1000000", "--work-dir", wd],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seen, deadline = [], time.time() + 240
    try:
        for line in p.stdout:
            seen.append(line)
            if re.match(r"^step \d+:", line):
                break
            assert time.time() < deadline, "".join(seen)[-3000:]
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    seen.append(out)
    assert p.returncode == 0, "".join(seen)[-3000:]
    m = re.search(r"checkpoint saved at step (\d+)", out)
    assert m, out[-3000:]
    assert latest_step(os.path.join(wd, "ckpt")) == int(m.group(1)) >= 1
