"""Closed-loop video inference of BEVFormer-base through the port's
``BEVFormer2D.forward_test`` (upstream's ``BEVFormer.forward_test``) at
batch 1: scenes of frames played in order, ``prev_bev`` carried within a
scene by the program's own ``VideoState`` and dropped at each new scene.

The configuration's ``rig`` gives the cameras (fixed lidar-to-image
matrices, :func:`rig`); the seed gives the weights, a pool of frames of
FPN features staged on the card (each frame drawn from its own stream, so
that the check redraws only the frames it needs), and scenes: each a
seeded order of the pool's frames with seeded ego motion, as absolute
can-bus rows (:func:`scenes`).

Traffic keys: ``pool`` frames, ``scene_frames`` a scene, ``scenes``
generated (played in turn, then again), ``step_m`` (the range of a
frame's step along the heading), ``yaw_step_deg`` (the largest yaw change
a frame), ``warmup_frames``, ``check_positions`` (frames of the window's
first scene whose outputs the check compares), ``trace_seconds``.  A
window plays whole scenes until ``seconds`` have passed.

The check: ``bev_embed`` and every decoder layer's class scores and boxes
of the frames at ``check_positions`` of the window's first scene, against
the plain reference (``reference/bevformer.py``), which plays the scene's
frames from its start with its own ``prev_bev`` chain, in fp32 with TF32
off.  A frame whose sparse lift dropped a visible query fails.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from verbench.bevformer_flops import frame_flop, msda_launches, msda_least_s
from verbench.compare import spread_error
from verbench.driver import Driver as Base
from verbench.reference.arch import _stream
from verbench.reference.bevformer import HEAD, Ref, Video, make_weights
from verbench.reference.model import true_fp32

CHECKED = {"bev_embed": "bev_embed", "cls_scores": "all_cls_scores",
           "bbox_preds": "all_bbox_preds"}


def _pinhole(fov_deg, yaw_deg, position, wh) -> np.ndarray:
    """4 x 4 lidar-to-image matrix of a pinhole with square pixels looking
    along ``yaw_deg`` about +z (0 looks along +y)."""
    w, h = wh
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    intr = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    axes = np.stack([[c, s, 0.0], [0.0, 0.0, -1.0], [-s, c, 0.0]])
    ext = np.eye(4)
    ext[:3, :3] = axes                  # right, down, forward
    ext[:3, 3] = -axes @ np.asarray(position, np.float64)
    proj = np.eye(4)
    proj[:3, :3] = intr
    return (proj @ ext).astype(np.float32)


def rig(a) -> np.ndarray:
    """(1, cams, 4, 4) lidar-to-image matrices of the configuration's
    ``rig``."""
    r = a.spec["rig"]
    mats = []
    for yaw, fov in zip(r["yaw_deg"], r["fov_deg"]):
        rad = np.radians(yaw)
        pos = [-np.sin(rad) * r["radius_m"], np.cos(rad) * r["radius_m"],
               r["height_m"]]
        mats.append(_pinhole(fov, yaw, pos, r["image_size"]))
    return np.stack(mats[:a.num_cams])[None]


def scenes(seed: int, t) -> tuple:
    """(orders (scenes, scene_frames) of pool indices, each scene
    successive permutations of the pool; can_bus (scenes, scene_frames,
    18) float64, absolute as the dataset gives them)."""
    rng = np.random.default_rng([int(seed), 4099])
    n, length, pool = int(t["scenes"]), int(t["scene_frames"]), int(t["pool"])
    orders = np.stack([np.concatenate([
        rng.permutation(pool) for _ in range(-(-length // pool))])[:length]
        for _ in range(n)])
    lo, hi = t["step_m"]
    cb = np.zeros((n, length, 18))
    for s in range(n):
        pos = np.array([*rng.uniform(-1000.0, 1000.0, 2), 0.0])
        yaw = rng.uniform(0.0, 360.0)
        for k in range(length):
            step, turn = 0.0, 0.0
            if k:
                step = rng.uniform(lo, hi)
                turn = rng.uniform(-t["yaw_step_deg"], t["yaw_step_deg"])
                yaw = (yaw + turn) % 360.0
                rad = np.radians(yaw)
                pos = pos + step * np.array([np.cos(rad), np.sin(rad), 0.0])
            rad = np.radians(yaw)
            cb[s, k, :3] = pos
            cb[s, k, 3:7] = [np.cos(rad / 2), 0.0, 0.0, np.sin(rad / 2)]
            cb[s, k, 7:10] = rng.standard_normal(3)
            cb[s, k, 10:13] = [0.0, 0.0, np.radians(turn) / 0.5]
            cb[s, k, 13:16] = [step / 0.5, 0.0, 0.0]
            cb[s, k, 16] = rad
            cb[s, k, 17] = yaw
    return orders, cb


def build_model(a, weights, device):
    """The port's ``BEVFormer2D`` of the configuration, ``weights`` (by
    upstream's names) loaded strictly, in eval mode."""
    import dataclasses

    from vln_ver_tpu_torch.models.bev2d import BEV2DConfig, BEVFormer2D
    fields = {f.name for f in dataclasses.fields(BEV2DConfig)}
    kw = {}
    for key, value in a.m.items():
        if key not in fields:
            raise ValueError(f"{key!r} is not a field of the program's "
                             "BEV2DConfig")
        if isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v
                          for v in value)
        kw[key] = value
    kw["dtype"] = {"float32": torch.float32}[a.m["dtype"]]
    cfg = BEV2DConfig(**kw)
    with torch.device(device):
        model = BEVFormer2D(cfg, num_classes=a.num_classes,
                            code_size=a.code_size)
    prefix = f"{HEAD}."
    model.load_state_dict({k[len(prefix):]: v for k, v in weights.items()},
                          strict=True)
    return model.eval()


class Driver(Base):

    def plan(self):
        t = self.traffic
        self.length = int(t["scene_frames"])
        self.orders, self.can_bus = scenes(self.seed, t)
        self.check_at = sorted(int(k) for k in t["check_positions"])
        if self.check_at[-1] >= self.length:
            raise ValueError("check_positions beyond a scene")

    def features(self, frames):
        """One (len(frames), cams, h, w, C) tensor a level, frame ``v``
        drawn from its own stream of the seed."""
        a = self.arch
        out = [torch.empty((len(frames), a.num_cams, h, w, a.embed_dims),
                           dtype=torch.float32, device=self.device)
               for h, w in a.level_shapes]
        gen = torch.Generator(device=self.device)
        for i, v in enumerate(frames):
            gen.manual_seed(_stream(self.seed, 100 + int(v)))
            for lvl in out:
                lvl[i].normal_(generator=gen)
        return out

    def setup(self):
        from vln_ver_tpu_torch.models.bev2d import VideoState
        a = self.arch
        self.plan()
        weights = make_weights(a, self.seed, self.device)
        self.model = build_model(a, weights, self.device)
        del weights
        self.pool = self.features(range(int(self.traffic["pool"])))
        self.w2p = torch.from_numpy(rig(a)).to(self.device)
        self.shift = torch.zeros((1, 3), device=self.device)
        self.free()
        state = VideoState()
        n = len(self.orders)
        with torch.inference_mode():
            for k in range(int(self.traffic.get("warmup_frames", 4))):
                self.model.forward_test(self.frame(n - 1, k), state)
        self.settle()

    def frame(self, s, k):
        v = int(self.orders[s % len(self.orders), k])
        return {"features": [lvl[v:v + 1] for lvl in self.pool],
                "world2pixel": self.w2p, "origin_shift": self.shift,
                "can_bus": self.can_bus[s % len(self.orders), k],
                "scene_token": s}

    def run_window(self, seconds):
        from vln_ver_tpu_torch.models.bev2d import VideoState
        state = VideoState()
        self.kept, overflows = {}, []
        t0 = self.start_window()
        frames = s = 0
        with torch.inference_mode():
            while time.perf_counter() - t0 < seconds:
                for k in range(self.length):
                    out = self.model.forward_test(self.frame(s, k), state)
                    overflows.append(out["sca_overflow"])
                    if s == 0 and k in self.check_at:
                        self.kept[k] = {key: out[key]
                                        for key in CHECKED.values()}
                    frames += 1
                s += 1
        self.close_window()
        self.units = self.attempted = frames
        self.failed = sum(int(o) > 0 for o in overflows)
        launches = msda_launches(self.arch)
        self.counters["msda_launches_per_frame"] = len(launches)
        self.counters["msda_least_s_per_frame"] = sum(
            msda_least_s(x) for x in launches)

    def flop_per_unit(self):
        return frame_flop(self.arch)

    def install_spans(self, spans):
        """The per-layer metrics read the program's own spans."""

    def release(self):
        del self.model, self.pool
        self.free()

    def check(self, control=None):
        """The numbers compared.  With ``control`` (``'tf32'``) the
        reference computed with TF32 on takes the program's place."""
        a = self.arch
        if control is None and set(self.kept) != set(self.check_at):
            raise RuntimeError("the window did not play its first scene")
        if control not in (None, "tf32"):
            raise ValueError(f"no control {control!r} for an fp32 cell")
        last = self.check_at[-1]
        frames = [int(v) for v in self.orders[0, :last + 1]]
        feats = self.features(frames)
        w2p = torch.from_numpy(rig(a)).to(self.device)
        weights = make_weights(a, self.seed, self.device)
        worst = dict.fromkeys(CHECKED, 0.0)
        with torch.no_grad(), true_fp32():
            want = self._play(Ref(a, weights), feats, w2p)
            if control:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                got = self._play(Ref(a, weights), feats, w2p)
            else:
                got = self.kept
            for k in self.check_at:
                for name, key in CHECKED.items():
                    g = got[k][key].to(want[k][key].device)
                    worst[name] = max(worst[name],
                                      spread_error(g, want[k][key]))
        self.kept = {}
        return [self.number(name, v) for name, v in worst.items()]

    def _play(self, ref, feats, w2p):
        """The reference's outputs at ``check_positions``, playing the
        first scene from its start."""
        video, out = Video(ref), {}
        for k in range(self.check_at[-1] + 1):
            r = video.frame([lvl[k:k + 1] for lvl in feats], w2p,
                            self.can_bus[0, k], 0)
            if k in self.check_at:
                out[k] = r
        return out
