from .voxelformer import (load_checkpoint, state_dict_from_jax,  # noqa: F401
                          train_state_from_jax)
