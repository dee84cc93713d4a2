"""Closed-loop, back-to-back full forwards of the port's VoxelFormer (the
lift, the DETR decoder and the occupancy head), as ``get_occ`` and the
headline call it: ``model(features, world2pixel, origin_shift)`` under
``inference_mode``.

Traffic keys: ``pool`` viewpoints staged on the card in the compute dtype
before the window, ``batch``, ``cycles`` (permutations of the pool laid
end to end: batches cycle through them, no two the same),
``warmup_calls``, ``check_batches`` drawn from the seed among the first
``check_among`` batches of the window, ``trace_seconds``.

The check: each sampled batch's class scores and boxes of every decoder
layer, voxel embedding and occupancy logits, against the plain reference
in fp32 on the same inputs, viewpoint by viewpoint.  A batch whose sparse
lift dropped a visible query (``sca_overflow`` > 0) is a failed one.
"""

from __future__ import annotations

import time

import torch

from verbench import traffic as T
from verbench.compare import quantizer, spread_error
from verbench.driver import Driver as Base
from verbench.driver import valid_taps
from verbench.flops import forward_flop
from verbench.program import DTYPES, build_model
from verbench.reference.arch import make_weights
from verbench.reference.model import Ref, true_fp32

CHECKED = {"bev_embed": "bev_embed", "cls_scores": "all_cls_scores",
           "bbox_preds": "all_bbox_preds", "occupancy": "occupancy_preds"}


class Driver(Base):
    span_pairs = {"encoder": ("enc0", "enc1"), "decoder": ("enc1", "up0"),
                  "head": ("up0", "end")}

    def inputs(self, dtype):
        a, t = self.arch, self.traffic
        w2p, shift = T.cameras(a, t, self.seed)
        feats = T.features(a, t, self.seed, self.device, dtype)
        return (feats, torch.from_numpy(w2p).to(self.device),
                torch.from_numpy(shift).to(self.device))

    def plan(self):
        """The batches' order and the sample the check compares."""
        t = self.traffic
        self.batch = int(t["batch"])
        order = T.order(self.seed, int(t["pool"]), self.batch,
                        int(t.get("cycles", 200)))
        self.order = torch.from_numpy(order).to(self.device)
        self.check_at = set(self.sample(int(t["check_batches"]),
                                        int(t["check_among"]), 1))

    def setup(self):
        a = self.arch
        self.plan()
        weights = make_weights(a, self.seed, self.device)
        self.model, _ = build_model(a, weights, self.device)
        del weights
        self.pool = self.inputs(DTYPES[a.dtype])
        self.free()
        n = len(self.order)
        for k in range(int(self.traffic.get("warmup_calls", 3))):
            self.call(n - 1 - k)
        self.settle()

    def call(self, k):
        idx = self.order[k % len(self.order)]
        f, w, s = (x.index_select(0, idx) for x in self.pool)
        with torch.inference_mode():
            return self.model(f, w, s)

    def run_window(self, seconds):
        self.kept, overflows = {}, []
        t0 = self.start_window()
        k = 0
        while time.perf_counter() - t0 < seconds:
            out = self.call(k)
            overflows.append(out["sca_overflow"])
            if k in self.check_at:
                self.kept[k] = {key: out[key] for key in CHECKED.values()}
            k += 1
        self.close_window()
        self.units = self.attempted = k * self.batch
        self.failed = self.batch * sum(int(o) > 0 for o in overflows)
        self.counters["batch"] = self.batch

    def flop_per_unit(self):
        return forward_flop(self.arch)

    def install_spans(self, spans):
        head = self.model.pts_bbox_head
        spans.on_module(head.transformer.encoder, "enc0", "enc1")
        spans.on_module(head.up_sample, "up0")
        spans.on_module(self.model, after="end")

    def release(self):
        del self.model, self.pool
        self.free()

    def check(self, control=None):
        """The numbers compared.  With ``control`` (``compare.quantizer``'s
        name) the reference computed in that precision takes the
        program's place."""
        a = self.arch
        if control is None and set(self.kept) != self.check_at:
            raise RuntimeError(f"the window ended before the sampled batches "
                               f"{sorted(self.check_at)}")
        feats, w2p, shift = self.inputs(DTYPES[a.dtype])
        weights = make_weights(a, self.seed, self.device)
        ref = Ref(a, weights)
        low = Ref(a, weights, quant=quantizer(control) if control else None)
        worst = dict.fromkeys(CHECKED, 0.0)
        taps, layers = 0, 0
        with torch.no_grad(), true_fp32():
            for k in sorted(self.check_at):
                idx = self.order[k % len(self.order)].tolist()
                for j, v in enumerate(idx):
                    ins = (feats[v:v + 1].float(), w2p[v:v + 1],
                           shift[v:v + 1])
                    cap = []
                    r = ref.forward(*ins, capture=cap)
                    for loc, vis in cap:
                        taps += valid_taps(loc, vis, a.feat_h, a.feat_w)
                        layers += 1
                    got = low.forward(*ins) if control else None
                    for name, key in CHECKED.items():
                        lead = key.startswith("all_")
                        if control:
                            g = got[key][:, 0] if lead else got[key][0]
                        else:
                            g = self.kept[k][key]
                            g = g[:, j] if lead else g[j]
                        rv = r[key][:, 0] if lead else r[key][0]
                        worst[name] = max(worst[name], spread_error(g, rv))
                    del r, got
        self.counters["valid_taps_per_view_layer"] = taps / max(layers, 1)
        self.kept = {}
        return [self.number(name, v) for name, v in worst.items()]
