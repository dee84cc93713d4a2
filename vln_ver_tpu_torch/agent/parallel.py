"""Data-parallel agent updates and evaluation over processes (PyTorch port
of ``vln_ver_tpu/agent/parallel.py``).

The agent's mesh is a 1-axis data grid, ``parallel.mesh.make_mesh((N,
1))``: the parameters are replicated (``parallel.mesh.replicate``), the
stacked decision-step batch is split on its leading axis and the
gradients are averaged over the ranks
(:func:`~vln_ver_tpu_torch.parallel.mesh.allreduce_grads`).  Both agent
objectives are global means over the batch
(``parallel.mesh.global_mean``) and their random masks are drawn for the
global batch (``parallel.mesh.draw_rows``), so a sharded update equals the
one-process update.  Rollouts stay whole on every rank, except in
evaluation, where ranks split the episode list.
"""

from __future__ import annotations

from ..parallel.mesh import Mesh


def shard_agent_batch(mesh: Mesh, batch):
    """This rank's rows of every leaf (tensors, and the ``EpisodicMemory``
    namedtuple's) on the leading axis, which must divide by the mesh."""
    n, i = mesh.data_size, mesh.data_index

    def take(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(take(y) for y in x))
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by mesh "
                             f"size {n}")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return take(batch)

