"""Multi-process parallelism (PyTorch port of ``vln_ver_tpu/parallel``):
``torch.distributed`` bring-up and gathers (``multihost``) and the
(data, view) process grid (``mesh``).  Tensor and pipeline parallelism and
the multi-slice mesh are not ported (ROADMAP Queue 1, item 13b)."""

from .mesh import (Mesh, ViewShard, allreduce_grads,  # noqa: F401
                   data_parallel, make_mesh, parse_eval_mesh, replicate,
                   shard_batch, shard_views)
