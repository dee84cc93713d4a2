"""The product path that ``get_occ`` runs: ``ver_writer.dump_volumes`` over
an ``MP3DDataset``, with ``get_occ.make_bev_only(model)`` (the lift only),
back to back until the window is over.

The pool's fp32 features live in host memory as the HDF5 rows the dataset
reads (CLS token first), behind ``verbench.h5mem``'s stand-in for
``h5py``, which also takes the dump's writes: each volume is deflated with
zlib at the call's gzip level and only its byte count is kept, but for
the volumes the check compares.  The annotation, camera and origin files
are written to a temporary directory.

Traffic keys: ``pool``, ``batch``, ``pass_volumes`` (viewpoints a
``dump_volumes`` call writes, laid out from successive permutations of
the pool), ``gzip_level``, ``input_cast``, ``warmup_volumes``,
``check_volumes`` drawn from the seed among the first call's viewpoints,
``trace_seconds``.

The check: each sampled volume as written, in the dump layout (C, Z, H, W)
fp32, against the plain reference's lift of the same fp32 features.  A
call whose sparse lift dropped a visible query fails all its volumes.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch

from verbench import traffic as T
from verbench.compare import quantizer, spread_error
from verbench.driver import Driver as Base
from verbench.driver import valid_taps
from verbench.flops import forward_flop
from verbench.h5mem import MemoryH5
from verbench.program import build_model
from verbench.reference.arch import make_weights
from verbench.reference.model import Ref, true_fp32

FEATURE_FILE = "new_vit_base_patch16_197_imagenet.hdf5"


def token(v: int) -> str:
    return f"scan{v // 8:03d}_vp{v % 8:03d}"


class Driver(Base):
    span_pairs = {"lift": ("lift0", "lift1")}

    def plan(self):
        t = self.traffic
        self.batch = int(t["batch"])
        pool, per = int(t["pool"]), int(t["pass_volumes"])
        order = T.order(self.seed, pool, 1, int(t.get("cycles", 200)))
        self.passes = order.reshape(-1, per)
        self.check_views = self.sample(int(t["check_volumes"]), per, 2)
        self.check_views = [int(self.passes[0][i]) for i in self.check_views]

    def host_features(self):
        a, t = self.arch, self.traffic
        feats = T.features(a, t, self.seed, self.device, torch.float32,
                           cls_token=True)
        w2p, shift = T.cameras(a, t, self.seed)
        return feats.cpu().numpy(), w2p, shift

    def write_dataset(self, w2p, shift):
        """Annotation, camera and origin files of the pool, as the
        dataset reads them; returns the annotation file."""
        root = self.root
        os.makedirs(os.path.join(root, "world2pixel"), exist_ok=True)
        cams, cords = {}, {}
        for v in range(len(w2p)):
            scan, vp = token(v).split("_")
            cords[token(v)] = shift[v]
            for k in range(self.arch.num_cams):
                cams.setdefault(scan, {})[f"{vp}_i1_{k}"] = w2p[v, k].tolist()
        for scan, rows in cams.items():
            with open(os.path.join(root, "world2pixel", scan + ".json"),
                      "w") as f:
                json.dump(rows, f)
        with open(os.path.join(root, "scanvp2cord.pkl"), "wb") as f:
            pickle.dump(cords, f)
        ann = os.path.join(root, "mp3d_test.pkl")
        with open(ann, "wb") as f:
            pickle.dump([{"token": token(v)} for v in range(len(w2p))], f)
        return ann

    def setup(self):
        from vln_ver_tpu_torch.data.mp3d import MP3DDataset
        from vln_ver_tpu_torch.get_occ import make_bev_only
        a, t = self.arch, self.traffic
        self.plan()
        weights = make_weights(a, self.seed, self.device)
        self.model, self.ver = build_model(a, weights, self.device)
        del weights
        feats, w2p, shift = self.host_features()
        self.root = tempfile.mkdtemp(prefix="verbench-dump-")
        ann = self.write_dataset(w2p, shift)
        self.store = MemoryH5()
        rows = self.store.files.setdefault(
            os.path.join(self.root, FEATURE_FILE), {})
        for v in range(len(feats)):
            for k in range(a.num_cams):
                rows[f"{token(v)}_i1_{k}"] = feats[v, k][None]
        self.store.keep = {token(v) for v in self.check_views}
        self.savename = os.path.join(self.root, "ver.hdf5")
        self.dataset = MP3DDataset(
            ann, self.root, num_cams=a.num_cams, feat_hw=a.feat_h,
            voxel_num=a.voxel_num, occupancy_classes=a.occupancy_classes,
            test_mode=True)
        self.bev_only = make_bev_only(self.model)
        self.free()
        warm = int(t.get("warmup_volumes", 2 * self.batch))
        self.dump(self.passes[-1][:warm].tolist())
        self.store.kept.clear()
        self.settle()

    def dump(self, indices):
        from vln_ver_tpu_torch.ver_writer import dump_volumes
        with self.store.installed():
            return dump_volumes(
                lambda *args: self.bev_only(*args), self.dataset, self.ver,
                self.savename, batch_size=self.batch,
                gzip_level=int(self.traffic["gzip_level"]),
                indices=indices, device=self.device,
                input_cast=self.traffic.get("input_cast", "auto"))

    def run_window(self, seconds):
        self.store.reset_counts()
        t0 = self.start_window()
        written = failed = p = 0
        while time.perf_counter() - t0 < seconds:
            r = self.dump(self.passes[p % len(self.passes)].tolist())
            written += r["written"]
            failed += r["written"] if r["sca_overflow"] > 0 else 0
            p += 1
        self.close_window()
        self.units = self.attempted = written
        self.failed = failed
        self.counters["batch"] = self.batch
        if self.store.written:
            self.counters["write_ms_per_volume"] = (
                1e3 * self.store.write_s / self.store.written)

    def flop_per_unit(self):
        return forward_flop(self.arch, only_bev=True)

    def install_spans(self, spans):
        spans.on_call(self, "bev_only", "lift0", "lift1")

    def release(self):
        del self.model, self.bev_only
        self.dataset.close()
        del self.dataset
        self.kept = dict(self.store.kept)
        del self.store
        shutil.rmtree(self.root, ignore_errors=True)
        self.free()

    def check(self, control=None):
        a = self.arch
        if control is None:
            missing = {token(v) for v in self.check_views} - set(self.kept)
            if missing:
                raise RuntimeError(f"volumes {sorted(missing)} were not "
                                   "written in the window")
        feats, w2p, shift = self.host_features()
        weights = make_weights(a, self.seed, self.device)
        ref = Ref(a, weights)
        low = Ref(a, weights, quant=quantizer(control) if control else None)
        worst, taps, layers = 0.0, 0, 0
        with torch.no_grad(), true_fp32():
            for v in self.check_views:
                f = torch.from_numpy(feats[v:v + 1, :, 1:]).to(
                    self.device).reshape(1, a.num_cams, a.feat_h, a.feat_w,
                                         a.in_channels)
                ins = (f, torch.from_numpy(w2p[v:v + 1]).to(self.device),
                       torch.from_numpy(shift[v:v + 1]).to(self.device))
                cap = []
                r = ref.lift(*ins, capture=cap)[0]
                for loc, vis in cap:
                    taps += valid_taps(loc, vis, a.feat_h, a.feat_w)
                    layers += 1
                want = r.reshape(a.bev_z, a.bev_h, a.bev_w, a.embed_dims
                                 ).permute(3, 0, 1, 2)
                if control:
                    got = low.lift(*ins)[0].reshape(
                        a.bev_z, a.bev_h, a.bev_w, a.embed_dims
                    ).permute(3, 0, 1, 2)
                else:
                    got = torch.from_numpy(np.asarray(self.kept[token(v)]))
                worst = max(worst, spread_error(got.to(want.device), want))
        self.counters["valid_taps_per_view_layer"] = taps / max(layers, 1)
        self.kept = {}
        return [self.number("volume", worst)]
