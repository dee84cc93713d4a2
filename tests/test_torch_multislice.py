"""The multi-slice grid (``parallel.mesh.make_multislice_mesh``, ``train
--mesh S,D,V``) over 4 gloo processes, fp32 on the CPU at the tiny config
(the data and the 1-process run of tests/test_torch_mesh_train.py, batch
4, 3 steps).

* the layout: rank ``r = (s * D + d) * V + v``, the batch over ``(slice,
  data)`` jointly (index ``s * D + d`` of ``S * D``), the view group inside
  a slice, the slice group across slices, as JAX's
  ``make_multislice_mesh`` orders its devices;
* (2, 2, 1) and (2, 1, 2) against the flat (4, 1) and (2, 2) grids run in
  the same processes and against the 1-process run: the losses step for
  step within rtol 1e-5, every parameter within ``_hold_params``; the
  gradients are averaged within each slice, then over the slice group;
* the ``ValueError`` of a launch over 2 nodes with ``num_slices`` 4.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_mesh_train import (CONFIG, STEPS,  # noqa: F401
                                         _argv, _hold_params, _losses,
                                         _params, single)
from tests.test_torch_parallel import launch, worker_main

torch.set_num_threads(1)

# (multi-slice run, its flat counterpart)
RUNS = [(("ms221", "2,2,1"), ("flat41", "4,1")),
        (("ms212", "2,1,2"), ("flat22", "2,2"))]


def slice_worker(root: str, tmp: str) -> None:
    import torch.distributed as dist

    from vln_ver_tpu_torch.parallel import multihost
    from vln_ver_tpu_torch.parallel.mesh import (data_axis_size,
                                                 make_multislice_mesh)
    from vln_ver_tpu_torch.train import cli
    rank = multihost.process_index()
    layout = {}
    for shape in ((2, 2, 1), (2, 1, 2)):
        mesh = make_multislice_mesh(*shape)

        def ranks(g):
            return dist.get_process_group_ranks(g)
        layout[str(shape)] = dict(
            coords=list(mesh.coords), data_index=mesh.data_index,
            view_index=mesh.view_index, data_size=mesh.data_size,
            axis_size=data_axis_size(mesh), data=ranks(mesh.data_group),
            view=ranks(mesh.view_group), local=ranks(mesh.groups["local"]),
            slice=ranks(mesh.groups["slice"]))
    for pair in RUNS:
        for name, grid in pair:
            cli.main(_argv(root, os.path.join(tmp, name), "--max-steps",
                           str(STEPS), "--mesh", grid))
    with open(os.path.join(tmp, f"slices.{rank}.json"), "w") as f:
        json.dump(layout, f)


@pytest.fixture(scope="module")
def slice_runs(single):
    root, wd1, tmp = single
    launch(4, __file__, "slice_worker", timeout=240, root=root, tmp=str(tmp))
    return wd1, tmp, [json.load(open(tmp / f"slices.{r}.json"))
                      for r in range(4)]


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2)],
                         ids=["s2d2v1", "s2d1v2"])
def test_multislice_layout(slice_runs, shape):
    """JAX's slice-major order: ``np.reshape(devices, (S, D, V))``."""
    grid = np.arange(4).reshape(shape)
    n_s, n_d, n_v = shape
    for r, layout in enumerate(slice_runs[2]):
        got = layout[str(shape)]
        s, d, v = (int(i) for i in np.argwhere(grid == r)[0])
        assert got["coords"] == [s, d, v]
        assert got["data_index"] == s * n_d + d and got["view_index"] == v
        assert got["data_size"] == got["axis_size"] == n_s * n_d
        assert got["data"] == sorted(grid[:, :, v].reshape(-1).tolist())
        assert got["view"] == grid[s, d, :].tolist()
        assert got["local"] == grid[s].reshape(-1).tolist()
        assert got["slice"] == grid[:, d, v].tolist()


@pytest.mark.parametrize("pair", RUNS, ids=[p[0][0] for p in RUNS])
def test_multislice_training_matches_flat_and_one_process(slice_runs, pair):
    wd1, tmp, _ = slice_runs
    (name, _), (flat, _) = pair
    got = _losses(str(tmp / name))
    for ref in (_losses(str(tmp / flat)), _losses(wd1)):
        assert sorted(got) == sorted(ref) == [1, 2, 3]
        for step in ref:
            for k, v in ref[step].items():
                if k.startswith(("loss", "d0.", "d1.", "grad_norm")):
                    np.testing.assert_allclose(
                        got[step][k], v, rtol=1e-5, atol=1e-7,
                        err_msg=f"{name} step {step} {k}")
    for ref in (str(tmp / flat), wd1):
        _hold_params(_params(str(tmp / name)), _params(ref))


def test_multislice_refuses_a_node_count_it_does_not_match(monkeypatch):
    from vln_ver_tpu_torch.parallel.mesh import (make_multislice_mesh,
                                                 node_count)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert node_count() == 2
    with pytest.raises(ValueError, match="num_slices=4 but the launch spans "
                                         "2 nodes"):
        make_multislice_mesh(4, 1, 1)


def test_one_process_multislice_grid():
    from vln_ver_tpu_torch.parallel.mesh import (data_axis_size,
                                                 make_multislice_mesh,
                                                 parse_eval_mesh)
    mesh = make_multislice_mesh(1, 1, 1)
    assert mesh.axis_names == ("slice", "data", "view")
    assert data_axis_size(mesh) == 1 and mesh.writer and mesh.views is None
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_multislice_mesh(2, 2, 1)
    # the eval CLIs' --mesh stays (data, view), as JAX's does
    with pytest.raises(ValueError, match="'data' or 'data,view'"):
        parse_eval_mesh("1,1,1")


if __name__ == "__main__":
    worker_main(globals())
