"""``python -m vln_ver_tpu_torch.train --mesh`` over gloo processes against
the 1-process run, fp32 on the CPU at the tiny config
(configs/verformer/vocc_tiny.py: dropout 0.1 on, the auction matcher),
batch 4, 3 steps over a synthetic split.

* 4 processes as (2, 2) and as (4, 1): the losses step for step within
  rtol 1e-5 of the 1-process run, every parameter after 3 steps within
  rtol 1e-4 / atol 1e-5 (the port's training tolerance; the attention
  key biases, whose true gradient is 0, at AdamW's noise floor).  The global
  batches put viewpoints with different ``num_pos`` and ``num_occupied``
  on different data ranks (checked), so per-rank avg factors, or per-rank
  dropout masks, would move the losses off the 1-process run's.
* 2 processes (--mesh 2): only rank 0 writes checkpoints; both ranks
  restore from them with --resume and the third step's loss is the
  1-process run's.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import launch, worker_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
STEPS, BATCH = 3, 4


def _argv(root, work_dir, *extra):
    return [CONFIG, "--device", "cpu", "--batch-size", str(BATCH),
            "--log-interval", "1", "--work-dir", work_dir, "--cfg-options",
            f"data.train.data_root={root}",
            f"data.train.ann_file={root}/mp3d_trainval.pkl", *extra]


def _losses(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r for r in rows if "loss" in r}


def _params(work_dir, step=STEPS):
    from vln_ver_tpu_torch.utils.checkpoint import model_file
    return torch.load(model_file(os.path.join(work_dir, "ckpt",
                                              f"step_{step:08d}")),
                      weights_only=True)


def _hold_params(got, want):
    """Every parameter within rtol 1e-4 / atol 1e-5, but the attention key
    biases (the middle third of ``in_proj_bias``): softmax ignores them, so
    their true gradient is 0 and autograd's is the roundoff of a
    cancellation, whose bits follow the order of the gradient sum; AdamW
    turns it into steps of up to lr.  They are held to that noise floor,
    2 x steps x lr, as tests/test_agent_mesh.py holds JAX's."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].clone(), want[k].clone()
        if k.endswith("in_proj_bias"):
            e = w.shape[0] // 3
            torch.testing.assert_close(g[e:2 * e], w[e:2 * e], rtol=0,
                                       atol=2 * STEPS * 1e-4, msg=k)
            g[e:2 * e] = w[e:2 * e]
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5, msg=k)


def train_worker(root: str, runs: list) -> None:
    from vln_ver_tpu_torch.parallel import multihost
    from vln_ver_tpu_torch.train import cli
    from vln_ver_tpu_torch.utils import checkpoint
    saves = []
    real_save = checkpoint.save_state

    def counting_save(*args, **kw):
        saves.append(args[1])
        return real_save(*args, **kw)

    # the CLI imports save_state when it runs: it takes the counting one
    checkpoint.save_state = counting_save
    for work_dir, extra in runs:
        cli.main(_argv(root, work_dir, *extra))
    with open(os.path.join(root, f"saves.{multihost.process_index()}"),
              "w") as f:
        json.dump(saves, f)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.data import MP3DDataset, make_synthetic_dataset
    from vln_ver_tpu_torch.train import cli
    tmp = tmp_path_factory.mktemp("mesh_train")
    ver = build_ver_config(load_config(CONFIG))
    root = str(tmp / "data")
    ann = make_synthetic_dataset(root, num_scans=2, viewpoints_per_scan=4,
                                 num_cams=ver.num_cams, feat_hw=ver.feat_h,
                                 feat_dim=ver.in_channels,
                                 occ_dims=(ver.occ_zdim, ver.occ_ydim,
                                           ver.occ_xdim),
                                 pc_range=ver.pc_range)
    # unequal boxes per viewpoint (1 to 4 of the generator's 4), so that
    # the data ranks' num_pos differ as their num_occupied do
    with open(ann, "rb") as f:
        infos = pickle.load(f)
    for i, info in enumerate(infos):
        k = 1 + i % 4
        info.update(gt_boxes=info["gt_boxes"][:k], names=info["names"][:k],
                    labels=info["labels"][:k])
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    ds = MP3DDataset(ann, root, voxel_num=ver.voxel_num,
                     occupancy_classes=ver.occupancy_classes,
                     num_cams=ver.num_cams, feat_hw=ver.feat_h)
    pos = [int(np.asarray(ds[i]["gt_valid"]).sum()) for i in range(len(ds))]
    occ = [int((np.asarray(ds[i]["occ_dense"]) < ver.occupancy_classes)
               .sum()) for i in range(len(ds))]
    ds.close()
    # the first epoch's global batches (the CLI's shuffle of seed 0)
    order = np.random.default_rng(0).permutation(len(pos))[:2 * BATCH]
    for rows in order.reshape(-1, BATCH):
        assert len({pos[i] for i in rows}) > 1, pos
        assert len({occ[i] for i in rows}) > 1, occ
    wd = str(tmp / "single")
    cli.main(_argv(root, wd, "--max-steps", str(STEPS)))
    return root, wd, tmp


def test_mesh_training_matches_one_process(single):
    root, wd1, tmp = single
    runs = [(str(tmp / "m22"), ["--max-steps", str(STEPS), "--mesh", "2,2"]),
            (str(tmp / "m41"), ["--max-steps", str(STEPS), "--mesh", "4,1"])]
    launch(4, __file__, "train_worker", timeout=180, root=root, runs=runs)
    want = _losses(wd1)
    want_p = _params(wd1)
    assert sorted(want) == [1, 2, 3]
    for work_dir, _ in runs:
        got = _losses(work_dir)
        assert sorted(got) == sorted(want)
        for step in want:
            for k, v in want[step].items():
                if k.startswith(("loss", "d0.", "d1.", "grad_norm")):
                    np.testing.assert_allclose(
                        got[step][k], v, rtol=1e-5, atol=1e-7,
                        err_msg=f"{work_dir} step {step} {k}")
        _hold_params(_params(work_dir), want_p)


def test_rank0_checkpoints_and_every_rank_resumes(single):
    root, wd1, tmp = single
    wd = str(tmp / "resume")
    launch(2, __file__, "train_worker", timeout=150, root=root, runs=[
        (wd, ["--max-steps", "2", "--mesh", "2"]),
        (wd, ["--max-steps", str(STEPS), "--mesh", "2", "--resume"])])
    saves = [json.load(open(os.path.join(root, f"saves.{r}")))
             for r in range(2)]
    assert saves == [[2, STEPS], []]
    got, want = _losses(wd), _losses(wd1)
    assert sorted(got) == [1, 2, 3]
    np.testing.assert_allclose(got[3]["loss"], want[3]["loss"], rtol=1e-5)
    _hold_params(_params(wd), _params(wd1))


if __name__ == "__main__":
    worker_main(globals())
