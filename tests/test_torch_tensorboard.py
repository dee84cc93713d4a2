"""The port's Tensorboard event writer against the JAX package's: the same
bytes with the clock pinned, over the cases of tests/test_tensorboard.py;
each package's ``read_scalars`` reads the other's files; and the train
CLI with a TensorboardLoggerHook writes events that JAX's reader reads."""

import glob
import os
import struct
import time

import numpy as np
import pytest

from vln_ver_tpu.utils import tensorboard as jtb
from vln_ver_tpu_torch.utils import tensorboard as ttb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
LONG_TAG = "train/" + "very_long_metric_name_" * 8   # multi-byte varints


def _scalars(w):
    w.add_scalar("train/loss", 1.5, 10)
    w.add_scalar("train/loss", 0.75, 20)
    w.add_scalars({"val/miou": 42.0, "val/skipme": "nan-string"}, 30)


def _one(w):
    w.add_scalar("a", 1.0, 1)


def _long(w):
    w.add_scalar(LONG_TAG, 0.125, 7)


CASES = {"scalars": _scalars, "framing": _one, "long_tag": _long}


def _write(module, logdir, case):
    w = module.SummaryWriter(str(logdir))
    CASES[case](w)
    w.close()
    return w.path


@pytest.mark.parametrize("case", CASES)
def test_event_bytes_equal_jax(tmp_path, monkeypatch, case):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    jpath = _write(jtb, tmp_path / "jax", case)
    tpath = _write(ttb, tmp_path / "torch", case)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("case", CASES)
def test_each_reader_reads_the_other_writer(tmp_path, case):
    jpath = _write(jtb, tmp_path / "jax", case)
    tpath = _write(ttb, tmp_path / "torch", case)
    assert ttb.read_scalars(jpath) == jtb.read_scalars(jpath)
    assert jtb.read_scalars(tpath) == ttb.read_scalars(tpath)
    if case == "scalars":
        assert ttb.read_scalars(tpath) == [(10, "train/loss", 1.5),
                                           (20, "train/loss", 0.75),
                                           (30, "val/miou", 42.0)]


def test_crc_and_framing():
    assert ttb._crc32c(b"123456789") == 0xE3069283
    for data in (b"", b"123456789", bytes(32), struct.pack("<Q", 77)):
        assert ttb._masked_crc(data) == jtb._masked_crc(data)


def test_train_cli_writes_events_jax_reads(tmp_path, monkeypatch):
    """Two steps of ``python -m vln_ver_tpu_torch.train`` on vocc_tiny.py
    with a TensorboardLoggerHook: ``work_dir/tf_logs`` holds the train/
    scalars of both steps, as tools/train.py writes them, and they are the
    jsonl log's values in fp32."""
    from vln_ver_tpu_torch.train.cli import main as train_main

    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "tb.py"
    cfg.write_text(f"_base_ = [{CONFIG!r}]\n"
                   "log_config = dict(interval=1, hooks=[dict(type="
                   "'TextLoggerHook'), dict(type='TensorboardLoggerHook')])\n")
    train_main([str(cfg), "--device", "cpu", "--synthetic", "--max-steps",
                "2", "--batch-size", "2", "--work-dir", "wd"])
    (path,) = glob.glob("wd/tf_logs/events.out.tfevents.*")
    events = jtb.read_scalars(path)
    import json
    log = [json.loads(x) for x in open("wd/train_log.jsonl")]
    assert [m["step"] for m in log] == [1, 2]
    for m in log:
        got = {tag: v for step, tag, v in events if step == m["step"]}
        assert set(got) == {f"train/{k}" for k in m}
        for k, v in m.items():
            assert got[f"train/{k}"] == np.float32(v), k
