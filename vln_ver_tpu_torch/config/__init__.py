from .api import (Config, apply_cfg_options, build_train_config,  # noqa: F401
                  build_ver_config, dataset_kwargs, load_config)
