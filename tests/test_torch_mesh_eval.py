"""``python -m vln_ver_tpu_torch.test --mesh 3`` over 3 gloo processes on
5 synthetic samples (contiguous shards of 2, 2 and 1: the last rank is one
short, and one batch of each rank is padded): every rank returns the
1-process run's metrics, every key, to the last bit of the gathered rows
and summed histograms (rtol 1e-12).  The tiny config
(configs/verformer/vocc_tiny.py), random weights from seed 0."""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import launch, worker_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
N = 5


def _argv(root):
    return [CONFIG, "--device", "cpu", "--limit", str(N), "--cfg-options",
            f"data.test.data_root={root}",
            f"data.test.ann_file={root}/mp3d_test.pkl"]


def eval_worker(root: str, out: str) -> None:
    from vln_ver_tpu_torch import test as test_cli
    from vln_ver_tpu_torch.parallel import multihost
    metrics = test_cli.main(_argv(root) + ["--mesh", "3",
                                           "--batch-size", "6"])
    with open(f"{out}.{multihost.process_index()}.json", "w") as f:
        json.dump(metrics, f)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.data import make_synthetic_dataset
    ver = build_ver_config(load_config(CONFIG))
    root = str(tmp_path_factory.mktemp("eval") / "data")
    make_synthetic_dataset(root, num_scans=N, viewpoints_per_scan=1,
                           split="test", num_cams=ver.num_cams,
                           feat_hw=ver.feat_h, feat_dim=ver.in_channels,
                           occ_dims=(ver.occ_zdim, ver.occ_ydim,
                                     ver.occ_xdim), pc_range=ver.pc_range)
    return root


def test_three_process_eval_equals_one_process(split, tmp_path):
    from vln_ver_tpu_torch import test as test_cli
    want = test_cli.main(_argv(split) + ["--batch-size", "2"])
    assert {"mAP_0.25", "miou", "iou"} <= set(want)
    out = str(tmp_path / "metrics")
    launch(3, __file__, "eval_worker", timeout=120, root=split, out=out)
    for rank in range(3):
        with open(f"{out}.{rank}.json") as f:
            got = json.load(f)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                       err_msg=f"rank {rank}: {k}")


if __name__ == "__main__":
    worker_main(globals())
