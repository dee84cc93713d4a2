"""Deformable-attention sampling: plain PyTorch versions and the CUDA
kernel."""

from .deform_attn import ms_deform_attn_2d, voxel_deform_attn_3d  # noqa: F401
from .deform_cuda import ms_deform_attn_2d_fused  # noqa: F401
from .sampling import bilinear_sample_2d, trilinear_sample_3d  # noqa: F401
