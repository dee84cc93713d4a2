"""MP3D viewpoint reader (PyTorch port of ``vln_ver_tpu/data/mp3d.py``).

Reads, per viewpoint, the ViT features (or, for the fused image path, the
raw uint8 views), the camera matrices, the origin shift and the token,
and the ground truth where the annotation has it: gravity boxes with
labels and validity, the room layout, and the dense occupancy labels with
their visibility mask.

Files under ``data_root`` (the reference's layout):
  annotation pkl: one dict per viewpoint with ``token = '{scan}_{vp}'``,
    and optionally ``gt_boxes`` (N, 7) raw (cx, cy, z_bottom, w, l, h,
    yaw), ``labels`` (N,), ``layout`` (7,), ``occ_gt_path`` (an (M, 2)
    int npy of (flat_index, class)) and ``occ_invalid_path`` (flat
    indices of unobserved voxels);
  new_vit_base_patch16_197_imagenet.hdf5: '{scan}_{vp}_i1_{deg}' ->
    (1, 197, 768), the CLS token is stripped (voxelformer.py:322-323);
  panorama_images.hdf5 (``from_images``): '{scan}_{vp}_i1_{deg}' ->
    (H, W, 3) uint8;
  world2pixel/{scan}.json: '{vp}_i1_{deg}' -> 4x4 row-major list;
  scanvp2cord.pkl: '{scan}_{vp}' -> origin shift.
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..boxes import gravity_boxes_from_raw
from ..occupancy import dense_from_sparse_np


# boxes per sample, padded (the JAX reader's default)
MAX_GT = 32


def ground_truth(info: Dict, test_mode: bool = False
                 ) -> Dict[str, np.ndarray]:
    """The box and layout ground truth of one annotation, at static shapes
    (vln_ver_tpu/data/mp3d.py:181-204): ``MAX_GT`` gravity boxes with
    labels and a validity mask, and one layout box with its flag.  Empty
    in test mode when the annotation has no boxes."""
    if test_mode and "gt_boxes" not in info:
        return {}
    raw = np.asarray(info.get("gt_boxes", np.zeros((0, 7))),
                     np.float32).reshape(-1, 7)
    n = min(len(raw), MAX_GT)
    boxes = np.zeros((MAX_GT, 9), np.float32)
    labels = np.zeros((MAX_GT,), np.int32)
    valid = np.zeros((MAX_GT,), bool)
    if n:
        boxes[:n] = gravity_boxes_from_raw(raw[:n])
        labels[:n] = np.asarray(info["labels"][:n], np.int32)
        valid[:n] = True
    out = dict(gt_boxes=boxes, gt_labels=labels, gt_valid=valid)
    if info.get("layout") is not None:
        out["gt_layout"] = gravity_boxes_from_raw(
            np.asarray(info["layout"], np.float32).reshape(1, 7))
        out["layout_valid"] = np.ones((1,), bool)
    else:
        out["gt_layout"] = np.zeros((1, 9), np.float32)
        out["layout_valid"] = np.zeros((1,), bool)
    return out


def occupancy_ground_truth(sparse: np.ndarray, invalid: Optional[np.ndarray],
                           voxel_num: int, occupancy_classes: int
                           ) -> Dict[str, np.ndarray]:
    """``occ_dense`` (voxel_num,) int32 labels, empty = ``occupancy_classes``,
    and ``occ_visible`` (voxel_num,) uint8, 0 on the unobserved voxels
    (reference mp3docc_dataset.py:505-517)."""
    visible = np.ones(voxel_num, np.uint8)
    if invalid is not None:
        visible[invalid] = 0
    return {"occ_dense": dense_from_sparse_np(sparse, voxel_num,
                                              occupancy_classes),
            "occ_visible": visible}


class MP3DDataset:
    def __init__(self, ann_file: str, data_root: str, num_cams: int = 6,
                 feat_hw: int = 14, voxel_num: int = 35 * 120 * 120,
                 occupancy_classes: int = 16, test_mode: bool = False,
                 from_images: bool = False, image_file: Optional[str] = None):
        with open(ann_file, "rb") as f:
            self.data_infos: List[Dict] = pickle.load(f)
        self.data_root = data_root
        self.num_cams = num_cams
        self.feat_hw = feat_hw
        self.voxel_num = voxel_num
        self.occupancy_classes = occupancy_classes
        self.test_mode = test_mode
        self._cam_cache: Dict[str, Dict] = {}
        self._cord_cache: Optional[Dict] = None
        self._h5 = None
        self._lock = threading.Lock()
        # the fused image path: samples carry the raw uint8 views under
        # "images" in place of "features"
        self.from_images = from_images
        self.image_file = image_file or os.path.join(
            data_root, "panorama_images.hdf5")
        self._img_h5 = None

    def __len__(self) -> int:
        return len(self.data_infos)

    def _get_feature(self, key: str) -> np.ndarray:
        # no feature cache: a dump reads each viewpoint once
        with self._lock:
            if self._h5 is None:
                import h5py   # only where features are read from disk
                self._h5 = h5py.File(os.path.join(
                    self.data_root,
                    "new_vit_base_patch16_197_imagenet.hdf5"), "r")
            ft = self._h5[key][:, 1:, :].astype(np.float32)
        return ft.reshape(self.feat_hw, self.feat_hw, -1)

    def _get_image(self, key: str) -> np.ndarray:
        # no image cache either: a dump reads each view once
        with self._lock:
            if self._img_h5 is None:
                import h5py
                self._img_h5 = h5py.File(self.image_file, "r")
            img = np.asarray(self._img_h5[key], np.uint8)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"image {key} of {self.image_file} has shape "
                             f"{img.shape}, want (H, W, 3)")
        return img

    def _get_world2pixel(self, scan: str, vp: str) -> np.ndarray:
        if scan not in self._cam_cache:
            path = os.path.join(self.data_root, "world2pixel",
                                scan + ".json")
            with open(path) as f:
                self._cam_cache[scan] = json.load(f)
        data = self._cam_cache[scan]
        return np.stack([np.asarray(data[f"{vp}_i1_{deg}"],
                                    dtype=np.float32)
                         for deg in range(self.num_cams)])

    def _get_origin_shift(self, scan: str, vp: str) -> np.ndarray:
        if self._cord_cache is None:
            path = os.path.join(self.data_root, "scanvp2cord.pkl")
            with open(path, "rb") as f:
                self._cord_cache = pickle.load(f)
        return np.asarray(self._cord_cache[f"{scan}_{vp}"],
                          dtype=np.float32)[:3]

    def cameras(self, index: int):
        """(world2pixel (cams, 4, 4), origin_shift (3,)) of one viewpoint,
        without reading its features or images."""
        scan, vp = self.data_infos[index]["token"].split("_")
        return (self._get_world2pixel(scan, vp),
                self._get_origin_shift(scan, vp))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        info = self.data_infos[index]
        token = info["token"]
        scan, vp = token.split("_")
        keys = [f"{scan}_{vp}_i1_{deg}" for deg in range(self.num_cams)]
        w2p, shift = self.cameras(index)
        sample = {"world2pixel": w2p, "origin_shift": shift, "token": token}
        if self.from_images:
            sample["images"] = np.stack([self._get_image(k) for k in keys])
        else:
            sample["features"] = np.stack([self._get_feature(k)
                                           for k in keys])
        sample.update(ground_truth(info, self.test_mode))
        if "occ_gt_path" in info:
            invalid = (np.load(info["occ_invalid_path"])
                       if "occ_invalid_path" in info else None)
            sample.update(occupancy_ground_truth(
                np.load(info["occ_gt_path"]), invalid, self.voxel_num,
                self.occupancy_classes))
        return sample

    def close(self) -> None:
        for name in ("_h5", "_img_h5"):
            f = getattr(self, name)
            if f is not None:
                f.close()
                setattr(self, name, None)


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict:
    """Stack per-sample dicts into a batch (tokens kept as a list)."""
    keysets = [set(s) for s in samples]
    if any(ks != keysets[0] for ks in keysets[1:]):
        diff = set.union(*keysets) - set.intersection(*keysets)
        raise ValueError(f"inconsistent sample keys in batch: {sorted(diff)}")
    return {k: ([s[k] for s in samples] if k == "token"
                else np.stack([s[k] for s in samples]))
            for k in samples[0]}


def iterate_batches(dataset, batch_size: int,
                    indices: Optional[Sequence[int]] = None):
    """Background-thread prefetching batch iterator (two batches ahead;
    the last batch may be short).  A worker exception is re-raised in the
    consumer: a dead loader fails loudly instead of hanging the main
    thread on an empty queue."""
    idx = list(indices if indices is not None else range(len(dataset)))
    nb = -(-len(idx) // batch_size)
    q: "queue.Queue" = queue.Queue(maxsize=2)

    def worker():
        try:
            for b in range(nb):
                chunk = idx[b * batch_size:(b + 1) * batch_size]
                q.put(collate([dataset[i] for i in chunk]))
            q.put(None)
        except BaseException as e:  # propagate to the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise RuntimeError("dataloader worker failed") from item
        yield item
