"""torch.nn modules of the VER stack and the BEVFormer-2D family."""

from .bev2d import BEV2DConfig, BEVFormer2D, build_bev2d  # noqa: F401
from .config import VERConfig  # noqa: F401
from .detector import VoxelFormer, build_model  # noqa: F401
from .temporal import VoxelTemporalSelfAttention  # noqa: F401
