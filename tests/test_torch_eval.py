"""The port's decode and eval path against the JAX package on the CPU:
occupancy decode (focal and ce), box and layout decode, the confusion
histogram (device form and host ``SSCMetrics``), the metrics, the
ground-truth reader and synthetic scenes, ``evaluate_model`` on shared
weights, and one drive of ``python -m vln_ver_tpu_torch.test``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import jax_params, port_model

from vln_ver_tpu import coders as jcoders
from vln_ver_tpu import occupancy as jocc
from vln_ver_tpu.config import build_ver_config as jax_build_ver_config
from vln_ver_tpu.config import load_config as jax_load_config
from vln_ver_tpu.data import MP3DDataset as JaxMP3DDataset
from vln_ver_tpu.data import make_synthetic_dataset as jax_make_synthetic
from vln_ver_tpu.evaluation import indoor_eval as jindoor
from vln_ver_tpu.evaluation import ssc_metrics as jssc
from vln_ver_tpu.evaluation.runner import evaluate_model as jax_evaluate
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu_torch import coders, occupancy
from vln_ver_tpu_torch import test as test_cli
from vln_ver_tpu_torch.config import build_ver_config, load_config
from vln_ver_tpu_torch.data import (MP3DDataset, make_synthetic_dataset,
                                    synthetic_samples)
from vln_ver_tpu_torch.evaluation import indoor_eval, ssc_metrics
from vln_ver_tpu_torch.parallel.mesh import Mesh
from vln_ver_tpu_torch.evaluation.runner import (evaluate_model,
                                                 occupancy_hists)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
# what tools/test.py prints, in its order
PRINTED = ["mAP_0.10", "mAP_0.25", "mAP_0.50", "mAP_0.75", "mAR_0.10",
           "mAR_0.25", "mAR_0.50", "mAR_0.75", "iou", "miou",
           "occ_precision", "occ_recall"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("loss_type,n", [("focal_loss", 16),
                                         ("ce_loss", 17)])
def test_decode_occupancy_matches_jax(loss_type, n):
    logits = np.random.default_rng(0).normal(
        -1.0, 2.0, (3, 500, n)).astype(np.float32)
    logits[0, :4] = 7.0              # ties: the lower class wins in both
    for thr in (0.25, 0.6):
        ref = jocc.decode_occupancy(jnp.asarray(logits), thr, loss_type)
        got = occupancy.decode_occupancy(_t(logits), thr, loss_type)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert occupancy.occupancy_num_classes(16, loss_type) == \
        jocc.occupancy_num_classes(16, loss_type)


def test_dense_from_sparse_matches_jax():
    sparse = np.array([[0, 3], [7, 1], [-1, 5], [10, 2], [9, 4]], np.int64)
    np.testing.assert_array_equal(
        occupancy.dense_from_sparse_np(sparse, 10, 16),
        jocc.dense_from_sparse_np(sparse, 10, 16))


def _box_inputs(seed, b=3, nq=20, ncls=5):
    rng = np.random.default_rng(seed)
    cls = rng.normal(-2.0, 1.5, (b, nq, ncls)).astype(np.float32)
    cls[0, 3:6, 1] = cls[0, 10, 2] = 0.5       # tied scores
    box = rng.normal(0.0, 1.0, (b, nq, 10)).astype(np.float32)
    box[..., :3] *= 8.0                        # some outside the range
    return cls, box


@pytest.mark.parametrize("thr", [None, 0.2, 0.999, 0.0101])
def test_decode_boxes_matches_jax(thr):
    cls, box = _box_inputs(1)
    kw = dict(max_num=12, num_classes=5, score_threshold=thr)
    got = coders.decode_boxes(_t(cls), _t(box), **kw)
    for i in range(cls.shape[0]):
        ref = jcoders.decode_boxes(jnp.asarray(cls[i]), jnp.asarray(box[i]),
                                   **kw)
        for name in ("scores", "labels", "valid"):
            np.testing.assert_array_equal(
                getattr(got, name)[i].numpy(), np.asarray(getattr(ref, name)),
                err_msg=name)
        np.testing.assert_allclose(got.bboxes[i].numpy(),
                                   np.asarray(ref.bboxes), rtol=1e-6,
                                   atol=1e-6)


def test_decode_layouts_matches_jax():
    lay = np.random.default_rng(2).normal(0, 30.0, (2, 4, 10)).astype(
        np.float32)
    got = coders.decode_layouts(_t(lay))
    for i in range(2):
        ref = jcoders.decode_layouts(jnp.asarray(lay[i]))
        np.testing.assert_allclose(got.bboxes[i].numpy(),
                                   np.asarray(ref.bboxes), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got.valid[i].numpy(),
                                      np.asarray(ref.valid))


def _labels(seed, n=17, shape=(2, 3000)):
    rng = np.random.default_rng(seed)
    pred = rng.integers(-2, n + 2, shape).astype(np.int32)
    gt = rng.integers(-2, n + 2, shape).astype(np.int32)
    weight = (rng.random(shape) < 0.7).astype(np.int32)
    return pred, gt, weight


def test_confusion_hist_device_matches_jax_and_host():
    pred, gt, weight = _labels(3)
    got = ssc_metrics.confusion_hist_device(_t(pred), _t(gt), _t(weight), 17)
    ref = jssc.confusion_hist_device(jnp.asarray(pred), jnp.asarray(gt),
                                     jnp.asarray(weight), 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    host = ssc_metrics.SSCMetrics(17)
    jhost = jssc.SSCMetrics(17)
    for i in range(2):
        host.add_batch(pred[i], gt[i], visible_mask=weight[i])
        jhost.add_batch(pred[i], gt[i], visible_mask=weight[i])
    np.testing.assert_array_equal(host.hist, got.numpy())
    np.testing.assert_array_equal(host.hist, jhost.hist)
    stats, jstats = host.get_stats(), jhost.get_stats()
    for k in stats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-12)


def test_occupancy_hists_match_jax_up_to_the_threshold_edge():
    """The decode-and-histogram of the eval loop against JAX's: a voxel
    may change cell only where its best score is within 1e-5 of the
    threshold (fp32 sigmoid); each such voxel moves one count."""
    rng = np.random.default_rng(4)
    logits = rng.normal(-1.0, 2.0, (2, 4000, 16)).astype(np.float32)
    thr = 0.25
    logits[0, :50] = -10.0
    logits[0, :50, 0] = np.log(thr / (1 - thr)) + rng.normal(
        0, 1e-6, 50).astype(np.float32)
    gt = rng.integers(0, 17, (2, 4000)).astype(np.int32)
    w = (rng.random((2, 4000)) < 0.8).astype(np.int32)

    class Cfg:
        occupancy_classes, occ_loss_type = 16, "focal_loss"

    got = occupancy_hists(_t(logits), _t(gt), _t(w), (thr,), Cfg)[0]
    pred = jocc.decode_occupancy(jnp.asarray(logits), thr)
    ref = jssc.confusion_hist_device(pred, jnp.asarray(gt), jnp.asarray(w),
                                     17)
    best = 1.0 / (1.0 + np.exp(-logits.max(-1).astype(np.float64)))
    near = int(((np.abs(best - thr) < 1e-5) & (w == 1)).sum())
    assert near >= 40
    diff = np.abs(got.numpy().astype(np.int64) - np.asarray(ref)).sum()
    assert diff <= 2 * near
    assert got.sum() == int(np.asarray(ref).sum()) == int(w.sum())


def test_indoor_eval_matches_jax():
    rng = np.random.default_rng(5)

    def boxes(n):
        b = np.zeros((n, 7), np.float32)
        b[:, :2] = rng.uniform(-3, 3, (n, 2))
        b[:, 2] = rng.uniform(0, 1, n)
        b[:, 3:6] = rng.uniform(0.5, 1.5, (n, 3))
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
        return b

    gts, preds = [], []
    for _ in range(3):
        g = boxes(4)
        p = np.concatenate([g + rng.normal(0, 0.1, g.shape).astype(
            np.float32), boxes(6)])
        gts.append({"boxes": g, "labels": rng.integers(0, 3, 4)})
        preds.append({"boxes": p, "labels": rng.integers(0, 3, 10),
                      "scores": rng.random(10).astype(np.float32)})
    got = indoor_eval.indoor_eval(gts, preds, classes=("a", "b", "c"))
    ref = jindoor.indoor_eval(gts, preds, classes=("a", "b", "c"))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12), k
    assert got["mAP_0.10"] > 0


def test_reader_and_synthetic_scenes_match_jax(tmp_path):
    """The port writes the JAX package's synthetic dataset byte for byte,
    its reader returns the JAX reader's samples (ground truth included),
    and ``synthetic_samples`` returns them without touching the disk."""
    kw = dict(num_cams=2, feat_hw=4, feat_dim=32, occ_dims=(8, 8, 8),
              split="test")
    jann = jax_make_synthetic(str(tmp_path / "j"), **kw)
    pann = make_synthetic_dataset(str(tmp_path / "p"), **kw)
    ref = JaxMP3DDataset(jann, str(tmp_path / "j"), voxel_num=512,
                         occupancy_classes=16, num_cams=2, feat_hw=4)
    port = MP3DDataset(pann, str(tmp_path / "p"), num_cams=2, feat_hw=4,
                       voxel_num=512, occupancy_classes=16)
    mem = synthetic_samples(**kw)
    assert len(ref) == len(port) == len(mem) == 4
    for i in range(4):
        r = ref[i]
        for s in (port[i], mem[i]):
            assert s.keys() == r.keys()
            for k in r:
                if k == "token":
                    assert s[k] == r[k]
                    continue
                assert s[k].dtype == r[k].dtype, k
                np.testing.assert_array_equal(s[k], r[k], err_msg=k)
    assert mem[0]["gt_valid"].sum() == 4
    # test mode without boxes in the annotation: no box ground truth
    port_test = MP3DDataset(pann, str(tmp_path / "p"), num_cams=2,
                            feat_hw=4, voxel_num=512, test_mode=True)
    assert "gt_boxes" in port_test[0]    # the synthetic annotation has them
    port.close()


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_build_ver_config(jax_load_config(CONFIG))
    tcfg = build_ver_config(load_config(CONFIG))
    params = jax_params(jcfg, seed=7)
    return jcfg, tcfg, params


def test_evaluate_model_matches_jax(tiny, tmp_path):
    """Same weights, same synthetic split (the JAX reader on disk, the
    port's samples in memory), batch 3 over 4 viewpoints (a short final
    batch).  The occupancy histograms could differ only on voxels whose
    best score lies within 1e-5 of a threshold; this data has none, so
    every metric must agree."""
    jcfg, tcfg, params = tiny
    thresholds = (0.25, 0.5)
    occ_dims = (tcfg.occ_zdim, tcfg.occ_ydim, tcfg.occ_xdim)
    kw = dict(num_cams=tcfg.num_cams, feat_hw=tcfg.feat_h,
              feat_dim=tcfg.in_channels, occ_dims=occ_dims,
              pc_range=tcfg.pc_range, split="test")
    root = str(tmp_path / "jax")
    dataset = JaxMP3DDataset(jax_make_synthetic(root, **kw), root,
                             voxel_num=jcfg.voxel_num,
                             occupancy_classes=jcfg.occupancy_classes,
                             num_cams=jcfg.num_cams, feat_hw=jcfg.feat_h)
    ref = jax_evaluate(JaxVoxelFormer(jcfg), {"params": params}, dataset,
                       occ_thresholds=thresholds, batch_size=3)
    samples = synthetic_samples(**kw)
    model = port_model(params, tcfg)
    got = evaluate_model(model, samples, occ_thresholds=thresholds,
                         batch_size=3)

    with torch.inference_mode():
        logits = model(*(_t(np.stack([s[k] for s in samples])) for k in (
            "features", "world2pixel", "origin_shift")))["occupancy_preds"]
    best = logits.sigmoid().max(-1).values.double().numpy()
    seen = np.stack([s["occ_visible"] for s in samples]) == 1
    for thr in thresholds:
        assert not ((np.abs(best - thr) < 1e-5) & seen).any()
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-9), k
    # a non-trivial comparison: occupancy was predicted at 0.25
    assert got["iou@0.25"] > 0 and got["occ_recall@0.25"] > 0


def test_cli_drive(tmp_path):
    """``python -m vln_ver_tpu_torch.test CONFIG --device cpu --synthetic
    --limit 2`` prints tools/test.py's metric keys."""
    out = subprocess.run(
        [sys.executable, "-m", "vln_ver_tpu_torch.test", CONFIG, "--device",
         "cpu", "--synthetic", "--limit", "2"], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    printed = [line.split(":")[0] for line in out.stdout.splitlines()
               if ":" in line]
    assert printed == PRINTED
    assert os.path.exists(tmp_path / "data" / "tiny" / "mp3d_test.pkl")


def test_cli_refuses_cuda_without_cuda_and_a_mesh(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_cli.main([CONFIG, "--device", "cuda", "--synthetic"])
    # a mesh the world cannot hold, and a batch the mesh cannot split
    with pytest.raises(ValueError, match="needs 2 processes"):
        test_cli.main([CONFIG, "--device", "cpu", "--mesh", "2,1"])
    with pytest.raises(ValueError, match="not divisible"):
        evaluate_model(None, [], batch_size=3, mesh=Mesh((2, 1), 0, 0))
