from .mp3d import MP3DDataset, collate, iterate_batches  # noqa: F401
from .nuscenes import (NuScenesAdapter, make_synthetic_nuscenes,  # noqa: F401
                       synthetic_nuscenes)
from .synthetic import (make_synthetic_dataset,  # noqa: F401
                        synthetic_samples)
