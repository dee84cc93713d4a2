"""Multi-process parallelism (PyTorch port of ``vln_ver_tpu/parallel``):
``torch.distributed`` bring-up and gathers (``multihost``), the process
grids with their data, view and multi-slice axes (``mesh``), tensor
parallelism (``tensor``) and pipeline parallelism (``pipeline``).

JAX's ``batch_pspecs``, ``pad_and_shard`` and ``params_on_mesh`` place
arrays on devices and have no counterpart: a rank takes its rows with
``shard_batch``, the eval pads its own short batch, and a tensor-parallel
state is brought to its replicated layout by ``tensor.gathered``.
``stage_layers`` takes the place of ``stack_layer_params``."""

from .mesh import (Mesh, ViewShard, allreduce_grads,  # noqa: F401
                   data_axis_size, data_parallel, make_mesh,
                   make_multislice_mesh, parse_eval_mesh, replicate,
                   shard_batch, shard_views)
from .pipeline import (make_pp_mesh, pipeline_apply,  # noqa: F401
                       sequential_apply, stage_layers)
from .tensor import (gathered, make_tp_mesh, param_pspec,  # noqa: F401
                     shard_params, shard_state, tp_fraction)
