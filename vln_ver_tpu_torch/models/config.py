"""Static model configuration for the VER stack (PyTorch port).

The port's own copy of ``VERConfig``: one frozen dataclass drives every
module and its defaults reproduce the active reference config
(projects/configs/verformer/vocc.py).  ``dtype`` is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import torch

# MP3D's focal-mode REAL semantic class count (vocc.py:44-46: 16 classes
# + empty handled as an extra sigmoid threshold, not a channel).  A
# ce_loss config carrying exactly this count is near-certainly a copied
# focal config that forgot ce mode needs empty INCLUDED as the last
# channel (17 for MP3D).
MP3D_FOCAL_REAL_CLASSES = 16


@dataclasses.dataclass(frozen=True)
class VERConfig:
    # -- grid geometry (vocc.py:9-14) --
    pc_range: Tuple[float, ...] = (-6.0, -6.0, -1.5, 6.0, 6.0, 2.0)
    bev_z: int = 4
    bev_h: int = 15
    bev_w: int = 15
    occupancy_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)

    # -- inputs (voxelformer.py:282-289; ViT-B/16 patch features) --
    num_cams: int = 6
    feat_h: int = 14
    feat_w: int = 14
    in_channels: int = 768

    # -- transformer (vocc.py:107-166) --
    embed_dims: int = 768
    num_heads: int = 8
    encoder_layers: int = 3
    sca_num_points: int = 8       # per-query sampling points in SCA
    decoder_layers: int = 6
    decoder_num_points: int = 4
    num_levels: int = 1
    ffn_dim: int = 1536           # _ffn_dim_ = 2 * embed
    dropout_rate: float = 0.1

    # -- queries / classes (vocc.py:19,38-46,94-104) --
    num_query: int = 100
    num_layout_query: int = 10
    num_classes: int = 17
    occupancy_classes: int = 16
    code_size: int = 10
    num_reg_fcs: int = 2
    num_occ_fcs: int = 2
    occ_dims: int = 128
    bbox_max_num: int = 50
    post_center_range: Tuple[float, ...] = (-10.0, -10.0, -5.0,
                                            10.0, 10.0, 5.0)
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 0.25
    loss_occ_weight: float = 1.0
    loss_layout_weight: float = 0.25

    # -- mode flags (vocc.py:15-17, head kwargs) --
    only_occ: bool = False
    only_det: bool = False
    add_layout: bool = False
    refine_occ: bool = True
    occ_layout: str = "zhwc"
    with_box_refine: bool = True
    occ_loss_type: str = "focal_loss"
    occ_ce_includes_empty: bool = False
    use_temporal_self_attn: bool = False
    tsa_num_points: int = 4
    num_bev_queue: int = 2
    decoder_on_bev: bool = False
    voxel_2_bev_type: str = "mlp"   # 'mlp' | 'pool'
    layout_range: Tuple[float, ...] = (-50.0, -50.0, -5.0, 50.0, 50.0, 5.0)

    # -- execution --
    # compute dtype for the transformer stack; projections stay fp32
    dtype: torch.dtype = torch.float32
    # accepted so configs written for the JAX package load unchanged; the
    # port selects nothing with it (a CUDA tensor always launches the
    # hand-written kernel, a CPU tensor always takes the plain version)
    deform_impl: str = "onehot"
    remat_encoder: bool = False
    # capacity-bounded sparse lift: each camera attends from at most this
    # many visible queries (0 = the dense lift); size it with
    # geometry.max_visible_queries / python -m
    # vln_ver_tpu_torch.check_query_capacity
    sca_query_capacity: int = 0

    def __post_init__(self):
        # CE-mode occupancy labeling trap: in ce_loss mode the channel set
        # must INCLUDE empty as its last channel, but the default
        # occupancy_classes=16 is the focal-mode MP3D real-class count
        if self.occ_loss_type == "ce_loss" and not self.occ_ce_includes_empty:
            if self.occupancy_classes == MP3D_FOCAL_REAL_CLASSES:
                raise ValueError(
                    "occ_loss_type='ce_loss' with occupancy_classes=16: "
                    "ce mode needs occupancy_classes to include the empty "
                    "class as its last channel (MP3D: 17 = 16 semantic + "
                    "empty). If 16 really is your including-empty count, "
                    "set occ_ce_includes_empty=True.")
            warnings.warn(
                f"occ_loss_type='ce_loss' with occupancy_classes="
                f"{self.occupancy_classes}: ce mode treats the LAST "
                "channel as the empty class — make sure this count "
                "INCLUDES empty (real classes + 1). Set "
                "occ_ce_includes_empty=True to affirm and silence this "
                "warning.", stacklevel=2)

    @property
    def bev_num(self) -> int:
        return self.bev_z * self.bev_h * self.bev_w

    @property
    def occ_zdim(self) -> int:
        return round((self.pc_range[5] - self.pc_range[2])
                     / self.occupancy_size[2])

    @property
    def occ_ydim(self) -> int:
        return round((self.pc_range[4] - self.pc_range[1])
                     / self.occupancy_size[1])

    @property
    def occ_xdim(self) -> int:
        return round((self.pc_range[3] - self.pc_range[0])
                     / self.occupancy_size[0])

    @property
    def voxel_num(self) -> int:
        return self.occ_zdim * self.occ_ydim * self.occ_xdim

    @property
    def predicts_layout(self) -> bool:
        """Whether the forward runs the layout branches: the reference's
        ``only_det`` branch takes precedence over ``add_layout``."""
        return self.add_layout and not self.only_det

    @property
    def head_dim(self) -> int:
        return self.embed_dims // self.num_heads
