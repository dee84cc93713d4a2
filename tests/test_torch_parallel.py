"""The port's multi-process helpers (``vln_ver_tpu_torch.parallel``) in 1
and 3 gloo processes, each against the JAX functions' values for the same
n and process count: ``shard_indices``, ``shard_size``,
``allgather_results`` with a trailing empty rank (n = 2 over 3),
``allreduce_sum``, mesh parsing and ``shard_batch``.

The module is also the process launcher of the other multi-process tests
(``launch``): each rank runs ``python <test file> <function> <json
kwargs>`` with torchrun's environment on a free port, under a per-test
timeout, so that a hung collective fails its test instead of eating the
suite's clock.  A test file's worker functions import torch and the port
only."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world: int, test_file: str, func: str, timeout: float = 120,
           **kwargs) -> list:
    """Run ``func(**kwargs)`` of ``test_file`` in ``world`` gloo processes;
    returns each rank's stdout.  Fails (and kills every rank) when a rank
    fails or the ranks outlive ``timeout`` seconds."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, test_file, func, json.dumps(kwargs)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def worker_main(namespace: dict) -> None:
    """The entry of a worker process: bring up gloo from the environment,
    run the named function of ``namespace`` and tear the group down."""
    from vln_ver_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize_if_needed("cpu")
    try:
        namespace[sys.argv[1]](**json.loads(sys.argv[2]))
    finally:
        multihost.shutdown()


# ---- workers ----------------------------------------------------------------

def helpers_worker(out: str, n: int, per_rank_rows: list) -> None:
    from vln_ver_tpu_torch.parallel import multihost
    from vln_ver_tpu_torch.parallel.mesh import parse_eval_mesh, shard_batch
    rank = multihost.process_index()
    idx = multihost.shard_indices(n)
    rows = per_rank_rows[rank]
    local = (np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
             + 100 * rank)
    gathered = multihost.allgather_results(local, max(per_rank_rows))
    flags = multihost.allgather_results(np.ones((rows, 2), bool),
                                        max(per_rank_rows))
    summed = multihost.allreduce_sum(np.array([rank, 1.0, 2.5]))
    mesh = parse_eval_mesh(str(multihost.process_count()))
    local_b = shard_batch(mesh, _rows_batch())
    assert parse_eval_mesh(None).shape == mesh.shape   # the default grid
    res = dict(idx=np.asarray(list(idx), np.int64),
               size=multihost.shard_size(n),
               gathered=np.asarray(gathered, np.float32).reshape(-1, 3),
               flags=np.asarray(flags, bool).reshape(-1, 2),
               summed=summed, mesh=np.asarray(mesh.shape),
               mesh_index=np.asarray([mesh.data_index, mesh.view_index]),
               features=local_b["features"], shift=local_b["origin_shift"])
    np.savez(f"{out}.{rank}.npz", **res)


# ---- tests ------------------------------------------------------------------

def _jax_shards(n: int, count: int):
    """The JAX helpers' values for ``count`` processes: shard_indices and
    shard_size with process_index / process_count patched."""
    from unittest import mock

    from vln_ver_tpu.parallel import multihost as jmh
    out = []
    for p in range(count):
        with mock.patch.object(jmh, "process_index", lambda p=p: p), \
                mock.patch.object(jmh, "process_count", lambda: count):
            out.append((list(jmh.shard_indices(n)), jmh.shard_size(n)))
    return out


def _rows_batch() -> dict:
    return {"features": np.arange(6 * 2, dtype=np.float32).reshape(6, 2),
            "origin_shift": np.arange(6 * 3).reshape(6, 3)}


def _jax_shard_batch(count: int, batch: dict) -> dict:
    """Each data shard of JAX's ``shard_batch`` on a (count, 1) mesh."""
    import jax

    from vln_ver_tpu.parallel import make_mesh, shard_batch
    mesh = make_mesh((count, 1), devices=jax.devices()[:count])
    shards = {}
    for k, v in shard_batch(mesh, batch).items():
        parts = sorted(v.addressable_shards, key=lambda s: s.index[0].start
                       or 0)
        shards[k] = [np.asarray(s.data) for s in parts]
    return shards


@pytest.mark.parametrize("n", [2, 5, 9])
def test_single_process_helpers_match_jax(n):
    from vln_ver_tpu.parallel import multihost as jmh
    from vln_ver_tpu_torch.parallel import multihost
    assert list(multihost.shard_indices(n)) == list(jmh.shard_indices(n))
    assert multihost.shard_size(n) == jmh.shard_size(n)
    local = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got = multihost.allgather_results(local, n)
    want = jmh.allgather_results(local, n)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(multihost.allreduce_sum(local),
                                  jmh.allreduce_sum(local))


@pytest.mark.parametrize("n", [2, 5, 7])
def test_shard_indices_per_rank_match_jax(n):
    from vln_ver_tpu_torch.parallel import multihost
    for p, (idx, size) in enumerate(_jax_shards(n, 3)):
        assert list(multihost.shard_indices(n, p, 3)) == idx
        assert multihost.shard_size(n, 3) == size


def test_three_processes_trailing_empty_rank(tmp_path):
    """n = 2 over 3 processes: the third shard is empty and still enters
    every collective; rows come back in (process, index) order."""
    n, rows = 2, [1, 1, 0]
    out = str(tmp_path / "helpers")
    launch(3, __file__, "helpers_worker", timeout=90, out=out, n=n,
           per_rank_rows=rows)
    jax_shards = _jax_shards(n, 3)
    want_rows = np.concatenate([
        np.arange(r * 3, dtype=np.float32).reshape(r, 3) + 100 * p
        for p, r in enumerate(rows)])
    jshards = _jax_shard_batch(3, _rows_batch())
    for p in range(3):
        z = np.load(f"{out}.{p}.npz")
        assert list(z["idx"]) == jax_shards[p][0]
        assert int(z["size"]) == jax_shards[p][1]
        np.testing.assert_array_equal(z["gathered"], want_rows)
        assert z["flags"].shape == (sum(rows), 2) and z["flags"].all()
        np.testing.assert_array_equal(z["summed"], [3.0, 3.0, 7.5])
        assert list(z["mesh"]) == [3, 1] and list(z["mesh_index"]) == [p, 0]
        np.testing.assert_array_equal(z["features"], jshards["features"][p])
        np.testing.assert_array_equal(z["shift"],
                                      jshards["origin_shift"][p])


def test_mesh_shapes_and_sharding_rules():
    from vln_ver_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                 parse_eval_mesh, shard_batch)
    mesh = parse_eval_mesh("1")
    assert mesh.shape == (1, 1) and mesh.views is None and mesh.writer
    assert parse_eval_mesh(None) is None     # one process: no mesh
    assert make_mesh().shape == (1, 1)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh((2, 1))
    with pytest.raises(ValueError, match="needs 2 processes"):
        parse_eval_mesh("1,2")
    with pytest.raises(ValueError, match="data"):
        parse_eval_mesh("1,1,1")
    b = {"features": np.zeros((2, 6, 1)), "token": ["a", "b"]}
    assert shard_batch(mesh, b)["token"] == ["a", "b"]
    # V must divide the cameras and D the rows (a grid's coordinates,
    # without its process groups)
    with pytest.raises(ValueError, match="6 cameras do not divide over 4"):
        shard_batch(Mesh((1, 4), 0, 1), b)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(Mesh((4, 1), 1, 0), b)
    got = shard_batch(Mesh((2, 3), 1, 2), b)
    assert got["token"] == ["b"] and got["features"].shape == (1, 2, 1)


def test_agent_batch_sharding():
    from vln_ver_tpu_torch.agent.memory import init_memory
    from vln_ver_tpu_torch.agent.parallel import shard_agent_batch
    from vln_ver_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((1, 1))
    batch = dict(x=torch.arange(6), memory=init_memory(6, 4, 8))
    got = shard_agent_batch(mesh, batch)
    assert torch.equal(got["x"], batch["x"])
    assert type(got["memory"]).__name__ == "EpisodicMemory"
    assert got["memory"].features.shape[0] == 6


if __name__ == "__main__":
    worker_main(globals())
