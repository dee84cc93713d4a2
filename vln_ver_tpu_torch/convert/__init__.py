from .voxelformer import (load_checkpoint, state_dict_from_jax,  # noqa: F401
                          train_state_from_jax)
from .vit import load_hf_vit_state_dict, vit_state_dict_from_jax  # noqa: F401
from .policy import (policy_state_dict_from_jax,  # noqa: F401
                     pretrain_state_dict_from_jax)
