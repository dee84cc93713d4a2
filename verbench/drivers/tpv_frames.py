"""Closed-loop frames of TPVFormer's occupancy model through the port's
``TPVFormer.forward`` at batch 1 (upstream's test batch): the neck's four
FPN levels of six cameras in, the three planes and the 18-class logits of
the 200 x 200 x 16 lattice out, under ``inference_mode``.

The configuration's ``rig`` gives the cameras (fixed lidar-to-image
matrices, ``bev_video.rig``); the seed gives the weights, a pool of frames
of FPN features staged on the card (each frame drawn from its own stream,
so that the check redraws only the frames it needs), and the order:
seeded permutations of the pool laid end to end.

Traffic keys: ``pool`` frames, ``cycles`` (permutations of the pool),
``warmup_frames``, ``check_frames`` drawn from the seed among the first
``check_among`` frames of the window, ``trace_seconds``.

The check: the three planes and the logits of the sampled frames against
the plain reference (``reference/tpvformer.py``) in fp32 with TF32 off, on
the card.  A frame whose sparse lift dropped a visible query fails.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from verbench.bevformer_flops import msda_least_s
from verbench.compare import spread_error
from verbench.driver import Driver as Base
from verbench.drivers.bev_video import rig
from verbench.reference.arch import _stream
from verbench.reference.model import true_fp32
from verbench.reference.tpvformer import Ref, make_weights
from verbench.tpvformer_flops import frame_flop, msda_launches

CHECKED = ("tpv_hw", "tpv_zh", "tpv_wz", "logits")


def build_model(a, weights, device):
    """The port's ``TPVFormer`` of the configuration, ``weights`` (by
    upstream's names) loaded strictly, in eval mode."""
    from vln_ver_tpu_torch.models.tpv import TPVConfig, TPVFormer
    fields = {f.name for f in dataclasses.fields(TPVConfig)}
    kw = {}
    for key, value in a.m.items():
        if key not in fields:
            raise ValueError(f"{key!r} is not a field of the program's "
                             "TPVConfig")
        if isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v
                          for v in value)
        kw[key] = value
    kw["dtype"] = {"float32": torch.float32}[a.m["dtype"]]
    with torch.device(device):
        model = TPVFormer(TPVConfig(**kw))
    model.load_state_dict(weights, strict=True)
    return model.eval()


class Driver(Base):

    def plan(self):
        t = self.traffic
        rng = np.random.default_rng([self.seed, 4111])
        pool = int(t["pool"])
        self.order = np.concatenate([rng.permutation(pool) for _ in
                                     range(int(t.get("cycles", 50)))])
        self.check_at = set(self.sample(int(t["check_frames"]),
                                        int(t["check_among"]), 1))

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
        a = self.arch
        self.plan()
        weights = make_weights(a, self.seed, self.device)
        self.model = build_model(a, weights, self.device)
        del weights
        self.pool = self.features(range(int(self.traffic["pool"])))
        self.w2p = torch.from_numpy(rig(a)).to(self.device)
        self.free()
        for k in range(int(self.traffic.get("warmup_frames", 4))):
            self.call(len(self.order) - 1 - k)
        self.settle()

    def call(self, k):
        v = int(self.order[k % len(self.order)])
        with torch.inference_mode():
            return self.model([lvl[v:v + 1] for lvl in self.pool], self.w2p)

    def run_window(self, seconds):
        self.kept, overflows = {}, []
        t0 = self.start_window()
        k = 0
        while time.perf_counter() - t0 < seconds:
            out = self.call(k)
            overflows.append(out["ica_overflow"])
            if k in self.check_at:
                self.kept[k] = {key: out[key] for key in CHECKED}
            k += 1
        self.close_window()
        self.units = self.attempted = k
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
        if control is None and set(self.kept) != self.check_at:
            raise RuntimeError(f"the window ended before the sampled frames "
                               f"{sorted(self.check_at)}")
        if control not in (None, "tf32"):
            raise ValueError(f"no control {control!r} for an fp32 cell")
        at = sorted(self.check_at)
        frames = [int(self.order[k % len(self.order)]) for k in at]
        feats = self.features(frames)
        w2p = torch.from_numpy(rig(a)).to(self.device)
        ref = Ref(a, make_weights(a, self.seed, self.device))
        worst = dict.fromkeys(CHECKED, 0.0)
        with torch.no_grad(), true_fp32():
            for i, k in enumerate(at):
                ins = [lvl[i:i + 1] for lvl in feats]
                want = ref.forward(ins, w2p)
                if control:
                    torch.backends.cuda.matmul.allow_tf32 = True
                    torch.backends.cudnn.allow_tf32 = True
                    got = ref.forward(ins, w2p)
                    torch.backends.cuda.matmul.allow_tf32 = False
                    torch.backends.cudnn.allow_tf32 = False
                else:
                    got = self.kept[k]
                for key in CHECKED:
                    g = got[key].to(want[key].device)
                    worst[key] = max(worst[key],
                                     spread_error(g, want[key]))
                del want, got
        self.kept = {}
        return [self.number(key, v) for key, v in worst.items()]
