"""VLN agent layer (PyTorch port of ``vln_ver_tpu/agent``): cross-modal
policy over VER volumes with volume state estimation and episodic memory.

* ``text``    — transformer instruction encoder
* ``ver``     — VER volume tokenizer + volume state estimation head
* ``memory``  — fixed-capacity episodic memory (topological node bank)
* ``policy``  — dual-scale (local volume / global map) cross-modal policy
* ``env``     — R2R-format episode environment (host-side graph stepping)
* ``data``    — R2R loaders, vocabularies, the VER HDF5 reader
* ``rollout`` — greedy and sampled rollouts + SR/SPL evaluation, the
  imitation loss
* ``pretrain`` — MLM / SAP / OG pretraining, offline teacher records
* ``update``  — the trainers' clip + AdamW update
* ``cli_setup`` — the trainers' shared setup and pretrained-weight grafts
* ``crossmodal`` — DUET / LXMERT x-layers onto the fusion blocks
* ``replay``  — card-vs-CPU holds of a policy call and of an update

Only numpy and torch: nothing of the JAX package.
"""

from .policy import VLNPolicy, PolicyConfig  # noqa: F401
from .memory import (EpisodicMemory, init_memory,  # noqa: F401
                     memory_from_arrays, update_memory)
