"""The agent's data-parallel updates and evaluation over 2 gloo processes
against 1 process, on the CPU with the synthetic environment and small
policy of ``--synthetic`` (JAX's tests/test_agent_mesh.py, for the port's
process grid):

* ``pretrain_vln --mesh 2`` (MLM masking and dropout on) and ``train_vln
  --mesh 2`` (DAgger, student actions in half the rollouts), at the CLIs'
  learning rates: every update's losses within rtol 1e-6 of the 1-process
  run's, the parameters after 4 updates within 1e-5 in relative L2 (over
  every parameter: the attention key biases, whose true gradient is 0,
  take AdamW steps of up to lr from roundoff, as in JAX's test);
* ``test_vln --mesh 2 --batch 4`` (``evaluate_batched(mesh=)``): every
  episode's metrics equal the 1-process per-episode ``evaluate``'s.
"""

import importlib
import json
import os

import numpy as np
import torch

from tests.test_torch_parallel import launch, worker_main

torch.set_num_threads(1)

UPDATES = 4


def _runs(wd, mesh):
    m = ["--mesh", "2"] if mesh else []
    common = ["--synthetic", "--device", "cpu"]
    return [
        ("pretrain_vln", common + ["--steps", str(UPDATES), "--batch", "8",
                                   "--log-interval", "1",
                                   "--work-dir", f"{wd}/pre"] + m),
        ("train_vln", common + ["--steps", str(8 * UPDATES),
                                "--update-batch", "8", "--episode-batch",
                                "2", "--eval-interval",
                                "1000", "--eval-limit", "2", "--work-dir",
                                f"{wd}/vln"] + m),
        ("test_vln", common + ["--checkpoint", f"{wd}/vln/ckpt",
                               "--work-dir", f"{wd}/vln", "--limit", "7"]
         + (["--batch", "4"] + m if mesh else [])),
    ]


def agent_worker(out: str, runs: list) -> None:
    """Run each CLI of ``runs``, recording every update's losses at full
    precision and the per-episode metrics of each evaluation."""
    from vln_ver_tpu_torch.agent import rollout, update
    from vln_ver_tpu_torch.parallel import multihost
    rec, real_update = [], update.update
    real_metrics = rollout.episode_metrics

    def recording_update(*args, **kw):
        total, parts, gnorm = real_update(*args, **kw)
        rec[-1]["losses"].append([float(total)] + [float(parts[k])
                                                   for k in sorted(parts)])
        return total, parts, gnorm

    def recording_metrics(*args, **kw):
        per = real_metrics(*args, **kw)
        rec[-1]["episodes"].append(per)
        return per

    # the CLIs look both up when they run
    update.update, rollout.episode_metrics = (recording_update,
                                              recording_metrics)
    try:
        for cli, argv in runs:
            rec.append({"losses": [], "episodes": []})
            importlib.import_module(f"vln_ver_tpu_torch.{cli}").main(argv)
    finally:
        update.update, rollout.episode_metrics = real_update, real_metrics
    with open(f"{out}.{multihost.process_index()}.json", "w") as f:
        json.dump(rec, f)


def _params(path):
    from vln_ver_tpu_torch.utils.checkpoint import model_file
    return torch.load(model_file(path), weights_only=True)


def _rel_l2(got, want):
    num = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def test_two_process_agent_matches_one_process(tmp_path):
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    agent_worker(f"{one}/rec", _runs(one, mesh=False))
    launch(2, __file__, "agent_worker", timeout=180, out=f"{two}/rec",
           runs=_runs(two, mesh=True))
    with open(f"{one}/rec.0.json") as f:
        want = json.load(f)
    for rank in range(2):
        with open(f"{two}/rec.{rank}.json") as f:
            got = json.load(f)
        for run, (cli, _) in enumerate(_runs(one, False)):
            if cli == "test_vln":
                assert len(got[run]["episodes"][-1]) == 7
                assert got[run]["episodes"] == want[run]["episodes"], rank
                continue
            assert len(got[run]["losses"]) == UPDATES, cli
            np.testing.assert_allclose(got[run]["losses"],
                                       want[run]["losses"], rtol=1e-6,
                                       err_msg=f"{cli} rank {rank}")
    for sub in ("pre", "vln"):
        want_p = _params(os.path.join(one, sub, "ckpt"))
        got_p = _params(os.path.join(two, sub, "ckpt"))
        assert sorted(got_p) == sorted(want_p)
        assert _rel_l2(got_p, want_p) < 1e-5, sub


if __name__ == "__main__":
    worker_main(globals())
