"""nuScenes-format reader for the BEVFormer-2D family (the port's numpy
copy of ``vln_ver_tpu/data/nuscenes.py``).

An info pkl holds one record per sample with its camera projection
matrices, can-bus vector and 3D boxes; the per-view features come
precomputed from an HDF5, so ``models.bev2d.BEVFormer2D`` runs on
nuScenes-style data with no file I/O inside the forward.

Info record schema (one dict per sample):
  token          str
  lidar2img      (num_cams, 4, 4) float32, world -> pixel per camera
  can_bus        (18,) float32
  gt_boxes       (N, 9) float32 raw (cx, cy, z_bottom, w, l, h, yaw, vx,
                 vy), converted to gravity-centre cz on output (the
                 training objective's batch contract)
  gt_labels      (N,) int
  prev           the previous sample's token ('' at a scene's start): the
                 temporal queue
  scene_name     str
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..boxes import gravity_boxes_from_raw
from ..geometry import make_pinhole_world2pixel


class NuScenesAdapter:
    def __init__(self, ann_file: str, data_root: str,
                 feature_file: Optional[str] = None,
                 num_cams: int = 6, feat_hw: int = 14, max_gt: int = 32,
                 image_wh=(1600.0, 900.0), test_mode: bool = False):
        with open(ann_file, "rb") as f:
            self.infos: List[Dict] = pickle.load(f)
        self.by_token = {i["token"]: k for k, i in enumerate(self.infos)}
        self.data_root = data_root
        self.feature_file = feature_file or os.path.join(
            data_root, "nusc_features.hdf5")
        self.num_cams = num_cams
        self.feat_hw = feat_hw
        self.max_gt = max_gt
        self.image_wh = image_wh
        self.test_mode = test_mode
        self._h5 = None
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.infos)

    def _features(self, token: str) -> np.ndarray:
        import h5py
        with self._lock:
            if self._h5 is None:
                self._h5 = h5py.File(self.feature_file, "r")
            feat = self._h5[token][:]
        # (num_cams, fh*fw(+cls), C) -> (num_cams, fh, fw, C)
        if feat.shape[1] == self.feat_hw * self.feat_hw + 1:
            feat = feat[:, 1:]
        return feat.reshape(self.num_cams, self.feat_hw, self.feat_hw,
                            -1).astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        info = self.infos[index]
        n = min(len(info.get("gt_boxes", ())), self.max_gt)
        boxes = np.zeros((self.max_gt, 9), np.float32)
        labels = np.zeros((self.max_gt,), np.int32)
        valid = np.zeros((self.max_gt,), bool)
        if n:
            raw = np.asarray(info["gt_boxes"], np.float32)[:n]
            boxes[:n] = gravity_boxes_from_raw(raw)
            labels[:n] = np.asarray(info["gt_labels"], np.int32)[:n]
            valid[:n] = True
        return dict(
            token=info["token"],
            features=self._features(info["token"]),
            world2pixel=np.asarray(info["lidar2img"], np.float32),
            origin_shift=np.zeros((3,), np.float32),
            can_bus=np.asarray(info["can_bus"], np.float32),
            gt_boxes=boxes, gt_labels=labels, gt_valid=valid,
            prev=info.get("prev", ""),
        )

    def prev_index(self, index: int) -> Optional[int]:
        """Index of the previous frame of the same scene (the temporal
        queue), None at a scene's start."""
        prev = self.infos[index].get("prev", "")
        return self.by_token.get(prev) if prev else None


def synthetic_nuscenes(num_scenes: int = 2, samples_per_scene: int = 3,
                       num_cams: int = 6, feat_hw: int = 4,
                       feat_dim: int = 32, image_wh=(1600.0, 900.0),
                       seed: int = 0
                       ) -> Tuple[List[Dict], Dict[str, np.ndarray]]:
    """Synthetic nuScenes-style records and per-view features, in memory:
    (infos, token -> (num_cams, feat_hw**2, feat_dim) features).  Each
    scene is a temporal chain of samples 2 m apart along +x; the draws
    are those of the JAX package's ``make_synthetic_nuscenes`` for the
    same seed."""
    rng = np.random.default_rng(seed)
    infos, feats = [], {}
    for s in range(num_scenes):
        scene = f"scene{s:03d}"
        prev = ""
        for t in range(samples_per_scene):
            token = f"{scene}_t{t:02d}"
            pos = np.array([t * 2.0, 0.0, 0.0], np.float32)
            l2i = np.stack([
                make_pinhole_world2pixel(70.0, c * (360.0 / num_cams), pos,
                                         image_wh=image_wh)
                for c in range(num_cams)])
            can_bus = np.zeros((18,), np.float32)
            can_bus[0:2] = (2.0, 0.0) if t else (0.0, 0.0)
            can_bus[-2] = 0.0          # ego yaw (rad)
            can_bus[-1] = 0.0          # yaw delta (deg)
            n = int(rng.integers(1, 5))
            boxes = np.zeros((n, 9), np.float32)
            boxes[:, 0:2] = rng.uniform(-4, 4, (n, 2))
            boxes[:, 2] = -1.0
            boxes[:, 3:6] = rng.uniform(0.5, 2.0, (n, 3))
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
            infos.append(dict(
                token=token, scene_name=scene, lidar2img=l2i,
                can_bus=can_bus, gt_boxes=boxes,
                gt_labels=rng.integers(0, 10, n).astype(np.int64),
                prev=prev))
            feats[token] = rng.standard_normal(
                (num_cams, feat_hw * feat_hw, feat_dim)).astype(np.float32)
            prev = token
    return infos, feats


def make_synthetic_nuscenes(root: str, num_scenes: int = 2,
                            samples_per_scene: int = 3, num_cams: int = 6,
                            feat_hw: int = 4, feat_dim: int = 32,
                            image_wh=(1600.0, 900.0), seed: int = 0) -> str:
    """:func:`synthetic_nuscenes` written as the info pkl and the feature
    HDF5 under ``root``; returns the pkl's path."""
    import h5py

    infos, feats = synthetic_nuscenes(num_scenes, samples_per_scene,
                                      num_cams, feat_hw, feat_dim, image_wh,
                                      seed)
    os.makedirs(root, exist_ok=True)
    with h5py.File(os.path.join(root, "nusc_features.hdf5"), "w") as h5:
        for token, feat in feats.items():
            h5.create_dataset(token, data=feat)
    ann = os.path.join(root, "nusc_infos.pkl")
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    return ann


def collate(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Stack samples into a batch; the tokens stay lists."""
    out: Dict = {}
    for k in samples[0]:
        if k in ("token", "prev"):
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out
