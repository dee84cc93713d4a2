"""Tensor parallelism (``parallel.tensor``, ``train --tp-model``) against
JAX's rule and against the 1-process run, fp32 on the CPU at the tiny
config (configs/verformer/vocc_tiny.py, batch 4, 3 steps; the data and the
1-process run of tests/test_torch_mesh_train.py).

* ``param_pspec`` on the seven shapes of JAX's own test
  (tests/test_train_step.py), against JAX's ``param_pspec``;
  ``tp_fraction`` of the port's model against JAX's on the JAX parameters
  of the same config.
* ``train --tp-model`` in 4 gloo processes as (data 2, model 2) and (data
  1, model 4): the losses step for step within rtol 1e-5 of the 1-process
  run, every parameter within tests/test_torch_mesh_train.py's
  ``_hold_params``, and each rank's parameters and AdamW moments at rest
  the bytes of the rule; the train CLI's eval tick on the gathered
  parameters equal to a 1-process eval of the checkpoint.
* the (2, 2) run's checkpoints: the replicated state's keys, shapes and
  dtypes, its values the 1-process run's within the training tolerances;
  its step 2 resumed as ``--mesh 4`` (replicated), as (1, 4) and in one
  process: the third step's loss within rtol 1e-4 of the 1-process run's;
  ``restore_state`` into a sharded state takes exactly the slices of the
  files' tensors.
"""

import functools
import json
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

from tests.test_torch_mesh_train import (BATCH, CONFIG, STEPS,  # noqa: F401
                                         _argv, _hold_params, _losses,
                                         _params, single)
from tests.test_torch_parallel import launch, worker_main

torch.set_num_threads(1)

# (work dir, model axis, --mesh)
GRIDS = [("tp22", 2, "2"), ("tp14", 4, "1")]
# the resumes of tp22's step 2: (work dir, extra flags)
RESUMES = [("resume_m4", ["--mesh", "4"]),
           ("resume_tp14", ["--tp-model", "4", "--mesh", "1"])]


def _eval_tick(root):
    """The eval tick after the last step, over the train split, at
    tests/test_torch_checkpoint.py's threshold (the dataset's cfg-options
    first, after _argv's)."""
    return [f"data.val.ann_file={root}/mp3d_trainval.pkl",
            f"data.val.data_root={root}", "--eval-interval", str(STEPS),
            "--eval-limit", "0", "--occ-thresholds", "0.02"]


def tp_worker(root: str, tmp: str) -> None:
    from vln_ver_tpu_torch.parallel import multihost, tensor
    from vln_ver_tpu_torch.train import cli
    from vln_ver_tpu_torch.utils.checkpoint import restore_state
    rank = multihost.process_index()
    states = []
    real = tensor.shard_state

    def keep(*args, **kw):
        states.append(real(*args, **kw))
        return states[-1]

    bytes_ = {}
    with mock.patch.object(tensor, "shard_state", keep):
        for name, m, mesh in GRIDS:
            cli.main(_argv(root, os.path.join(tmp, name), *_eval_tick(root),
                           "--max-steps", str(STEPS), "--tp-model", str(m),
                           "--mesh", mesh, "--ckpt-interval", "2"))
            state = states[-1]
            bytes_[name] = dict(
                resident=tensor.resident_bytes(state),
                rule=tensor.rule_bytes(state, m),
                replicated=tensor.rule_bytes(state, 1, min_size=1 << 62),
                fraction=tensor.tp_fraction(state, state.tp.mesh))
        for name, flags in RESUMES:
            wd = os.path.join(tmp, name)
            multihost.run_once(lambda wd=wd: shutil.copytree(
                os.path.join(tmp, "tp22", "ckpt", "step_00000002"),
                os.path.join(wd, "ckpt", "step_00000002")))
            cli.main(_argv(root, wd, "--max-steps", str(STEPS), "--resume",
                           *flags))
    # restore_state into a sharded state on the (2, 2) grid: the slices
    # of the files' tensors, exactly
    from vln_ver_tpu_torch.config import (build_train_config,
                                          build_ver_config, load_config)
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.parallel.tensor import (gathered, make_tp_mesh,
                                                   shard_state)
    from vln_ver_tpu_torch.train import create_train_state
    cfg = load_config(CONFIG)
    state = shard_state(make_tp_mesh(2, 2), create_train_state(
        build_model(build_ver_config(cfg), "cpu", seed=0),
        build_train_config(cfg, 2)))
    ckpt = os.path.join(tmp, "tp22", "ckpt")
    restore_state(ckpt, STEPS, state)
    sliced = [tuple(p.shape) for p in state.model.parameters()]
    path = os.path.join(ckpt, f"step_{STEPS:08d}")
    want = torch.load(os.path.join(path, "model.pth"), weights_only=True)
    want_opt = torch.load(os.path.join(path, "train_state.pth"),
                          weights_only=True)["optimizer"]["state"]
    with gathered(state):
        full = [tuple(p.shape) for p in state.model.parameters()]
        exact = all(torch.equal(v, want[k])
                    for k, v in state.model.state_dict().items())
        got_opt = state.optimizer.state_dict()["state"]
        exact_opt = all(torch.equal(got_opt[i][k], want_opt[i][k])
                        for i in want_opt for k in want_opt[i])
    import torch.distributed as dist
    groups = {k: dist.get_process_group_ranks(g) for k, g in (
        ("data", state.tp.mesh.data_group), ("view", state.tp.mesh.view_group),
        ("model", state.tp.group))}
    with open(os.path.join(tmp, f"tp.{rank}.json"), "w") as f:
        json.dump(dict(bytes=bytes_, exact=exact, exact_opt=exact_opt,
                       sliced=sliced, full=full, step=state.step,
                       groups=groups), f)


@pytest.fixture(scope="module")
def tp_runs(single):
    root, wd1, tmp = single
    launch(4, __file__, "tp_worker", timeout=240, root=root, tmp=str(tmp))
    from vln_ver_tpu_torch.train import cli
    wd = str(tmp / "resume_one")
    shutil.copytree(str(tmp / "tp22" / "ckpt" / "step_00000002"),
                    os.path.join(wd, "ckpt", "step_00000002"))
    cli.main(_argv(root, wd, "--max-steps", str(STEPS), "--resume"))
    return root, wd1, tmp, [json.load(open(tmp / f"tp.{r}.json"))
                            for r in range(4)]


@pytest.mark.parametrize("shape", [(4096, 8), (8, 4096), (512, 512),
                                   (512, 513), (7, 9), (64,), (16, 16)])
def test_param_pspec_matches_jax(shape):
    from jax.sharding import PartitionSpec as P

    from vln_ver_tpu.parallel.tensor import param_pspec as jax_pspec
    from vln_ver_tpu_torch.parallel.tensor import param_pspec
    spec = jax_pspec(np.zeros(shape), 8)
    want = None if spec == P() else list(spec).index("model")
    assert param_pspec(shape, 8) == want


@pytest.mark.parametrize("min_size", [128, 1 << 15])
def test_tp_fraction_matches_jax(min_size):
    """The port's model against the JAX parameters of vocc_tiny.py, at
    model 4.  JAX creates the positional encoding only for a temporal
    config, the port always (inert, zeros in ``export_state_dict``); the
    JAX tree is given it, as ``state_dict_from_jax`` gives it zeros."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from vln_ver_tpu.config import build_ver_config as jax_ver
    from vln_ver_tpu.config import load_config as jax_load
    from vln_ver_tpu.models import VoxelFormer
    from vln_ver_tpu.parallel import tensor as jt
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.parallel.mesh import Mesh
    from vln_ver_tpu_torch.parallel.tensor import tp_fraction
    jcfg = jax_ver(jax_load(CONFIG))
    feats = np.zeros((1, jcfg.num_cams, jcfg.feat_h, jcfg.feat_w,
                      jcfg.in_channels), np.float32)
    w2p = np.tile(np.eye(4, dtype=np.float32), (1, jcfg.num_cams, 1, 1))
    params = jax.eval_shape(lambda: VoxelFormer(jcfg).init(
        jax.random.PRNGKey(0), feats, w2p, np.zeros((1, 3), np.float32)))
    params = dict(params["params"])
    head = dict(params["pts_bbox_head"])
    head["positional_encoding"] = {
        n: np.zeros((rows, jcfg.embed_dims), np.float32)
        for n, rows in (("row_embed", jcfg.bev_h), ("col_embed", jcfg.bev_w),
                        ("z_embed", jcfg.bev_z))}
    params["pts_bbox_head"] = head
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(1, 1, 4),
                    ("data", "view", "model"))
    with mock.patch.object(jt, "param_pspec", functools.partial(
            jt.param_pspec, min_size=min_size)):
        want = jt.tp_fraction(params, jmesh)
    model = build_model(build_ver_config(load_config(CONFIG)), "cpu", seed=0)
    mesh = Mesh((1, 1, 4), 0, 0, axis_names=("data", "view", "model"),
                coords=(0, 0, 0))
    assert tp_fraction(model, mesh, min_size) == want


def test_tp_state_in_one_process_is_the_replicated_state():
    """A (1, 1, 1) grid without a process group: one step of a sharded
    state equals the replicated step bit for bit; a sharded state is saved
    only in its replicated layout."""
    from tests.test_torch_train import TCFG, TRAIN, make_batch
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.parallel.tensor import (gathered, make_tp_mesh,
                                                   shard_state)
    from vln_ver_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_train_step)
    from vln_ver_tpu_torch.utils.checkpoint import host_snapshot
    tc = TrainConfig(**TRAIN)
    plain, sharded = (create_train_state(build_model(TCFG, "cpu", seed=0), tc)
                      for _ in range(2))
    mesh = make_tp_mesh(1, 1)
    shard_state(mesh, sharded, min_size=128)
    assert sharded.tp.axes
    for seed in range(2):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(seed, 2, cfg=TCFG).items()}
        losses = [float(make_train_step(TCFG, tc, grid)(
            state, batch, seed=1)["loss"])
            for state, grid in ((plain, None), (sharded, mesh))]
        assert losses[0] == losses[1]
    with pytest.raises(RuntimeError, match="gathered"):
        host_snapshot(sharded)
    with gathered(sharded):
        got, want = host_snapshot(sharded), host_snapshot(plain)
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)


@pytest.mark.parametrize("name,m,mesh", GRIDS, ids=[g[0] for g in GRIDS])
def test_tp_training_matches_one_process(tp_runs, name, m, mesh):
    root, wd1, tmp, _ = tp_runs
    want, got = _losses(wd1), _losses(str(tmp / name))
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for step in want:
        for k, v in want[step].items():
            if k.startswith(("loss", "d0.", "d1.", "grad_norm")):
                np.testing.assert_allclose(got[step][k], v, rtol=1e-5,
                                           atol=1e-7,
                                           err_msg=f"{name} step {step} {k}")
    _hold_params(_params(str(tmp / name)), _params(wd1))


def test_tp_grid_layout(tp_runs):
    """make_tp_mesh(2, 2): rank r = (d * V + v) * M + m; the rows split
    over the data group alone, which holds one rank of each data index."""
    for r, res in enumerate(tp_runs[3]):
        d, m = divmod(r, 2)
        assert res["groups"] == {"data": [m, 2 + m], "view": [r],
                                 "model": [2 * d, 2 * d + 1]}


@pytest.mark.parametrize("name,m,mesh", GRIDS, ids=[g[0] for g in GRIDS])
def test_tp_eval_tick_counts_each_viewpoint_once(tp_runs, name, m, mesh):
    """The train CLI's eval tick on the gathered parameters equals a
    1-process eval of the step's checkpoint over the same split."""
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.data import MP3DDataset
    from vln_ver_tpu_torch.evaluation.runner import evaluate_model
    from vln_ver_tpu_torch.models import VoxelFormer
    from vln_ver_tpu_torch.utils.checkpoint import load_model
    root, _, tmp, _ = tp_runs
    with open(tmp / name / "train_log.jsonl") as f:
        evals = [r for r in map(json.loads, f) if "iou" in r]
    assert [r["step"] for r in evals] == [STEPS]
    ver = build_ver_config(load_config(CONFIG))
    model = load_model(str(tmp / name / "ckpt"), VoxelFormer(ver))
    ds = MP3DDataset(f"{root}/mp3d_trainval.pkl", root,
                     voxel_num=ver.voxel_num,
                     occupancy_classes=ver.occupancy_classes,
                     num_cams=ver.num_cams, feat_hw=ver.feat_h)
    try:
        want = evaluate_model(model, ds, occ_thresholds=(0.02,),
                              batch_size=1)
    finally:
        ds.close()
    for k, v in evals[0].items():
        if k != "step":
            assert v == pytest.approx(round(float(want[k]), 4), abs=2e-4), k


@pytest.mark.parametrize("name,m,mesh", GRIDS, ids=[g[0] for g in GRIDS])
def test_tp_bytes_at_rest_follow_the_rule(tp_runs, name, m, mesh):
    ranks = tp_runs[3]
    for r in ranks:
        b = r["bytes"][name]
        assert b["resident"] == b["rule"], (name, b)
        assert b["fraction"] > 0.5
        # the sharded elements on a rank are 1/m of theirs
        full = b["replicated"]
        assert b["rule"] == pytest.approx(
            full * (1 - b["fraction"] + b["fraction"] / m), rel=1e-6)


def test_tp_checkpoint_is_the_replicated_layout(tp_runs):
    root, wd1, tmp, ranks = tp_runs
    path = str(tmp / "tp22" / "ckpt" / f"step_{STEPS:08d}")
    ref = os.path.join(wd1, "ckpt", f"step_{STEPS:08d}")
    got, want = _params(str(tmp / "tp22")), _params(wd1)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    _hold_params(got, want)
    got_s = torch.load(os.path.join(path, "train_state.pth"),
                       weights_only=True)
    want_s = torch.load(os.path.join(ref, "train_state.pth"),
                        weights_only=True)
    assert got_s["step"] == want_s["step"] == STEPS
    go, wo = got_s["optimizer"], want_s["optimizer"]
    assert go["param_groups"] == wo["param_groups"]
    assert sorted(go["state"]) == sorted(wo["state"])
    for i, st in wo["state"].items():
        assert {k: (v.shape, v.dtype) for k, v in st.items()} == {
            k: (v.shape, v.dtype) for k, v in go["state"][i].items()}
        torch.testing.assert_close(go["state"][i]["step"], st["step"])
    # every rank restored the slices of the files exactly
    for r in ranks:
        assert r["exact"] and r["exact_opt"] and r["step"] == STEPS
        assert r["sliced"] != r["full"]


@pytest.mark.parametrize("name", [r[0] for r in RESUMES] + ["resume_one"])
def test_tp_checkpoint_resumes(tp_runs, name):
    root, wd1, tmp, _ = tp_runs
    got, want = _losses(str(tmp / name)), _losses(wd1)
    assert sorted(got) == [STEPS]
    np.testing.assert_allclose(got[STEPS]["loss"], want[STEPS]["loss"],
                               rtol=1e-4)


if __name__ == "__main__":
    worker_main(globals())
