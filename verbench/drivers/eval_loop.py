"""``test.py``'s per-batch work through the port's evaluation runner
(``vln_ver_tpu_torch.evaluation.runner``), closed loop: the forward under
``inference_mode``, ``decode_outputs`` (the last decoder layer's boxes),
``occupancy_hists`` against seeded labels at each of ``occ_thresholds``,
and the host copies of the decoded boxes and the histograms that
``evaluate_model`` makes every batch, the histograms summed on the host.
The split-level mAP reduction that follows the loop is not timed.

Traffic keys: those of ``full_forward`` (``pool`` viewpoints staged on the
card, ``batch``, ``cycles``, ``warmup_calls``, ``check_batches`` among the
first ``check_among`` batches, ``trace_seconds``, the rig's ``fov_deg`` and
``position_scale``), ``occ_thresholds`` and ``num_boxes`` (the seeded
scenes of ``verbench.traffic.ground_truth``, whose ``occ_dense`` are the
labels, every voxel weighted).

The check: as ``full_forward``'s, the sampled batches' voxel embedding,
class scores and boxes of every decoder layer, and occupancy logits
against the plain reference in fp32; the control is the reference with
TF32 on.
"""

from __future__ import annotations

import numpy as np
import torch

from verbench import traffic as T
from verbench.compare import spread_error
from verbench.drivers.full_forward import CHECKED
from verbench.drivers.full_forward import Driver as Forward
from verbench.program import DTYPES
from verbench.reference.arch import make_weights
from verbench.reference.model import Ref, true_fp32


class Driver(Forward):
    span_pairs = {}

    def setup(self):
        from vln_ver_tpu_torch.evaluation.ssc_metrics import SSCMetrics
        from vln_ver_tpu_torch.occupancy import occupancy_num_classes
        a, t = self.arch, self.traffic
        self.thresholds = tuple(float(x) for x in t["occ_thresholds"])
        n = occupancy_num_classes(a.occupancy_classes, a.m["occ_loss_type"])
        gt = np.stack([g["occ_dense"] for g in T.ground_truth(a, t,
                                                              self.seed)])
        # the dense labels encode empty as occupancy_classes, the decode as
        # its last class: evaluate_model's mapping
        self.labels = torch.from_numpy(np.minimum(gt, n - 1)).to(
            self.device)
        self.weight = torch.ones_like(self.labels)
        self.ssc = SSCMetrics(n)
        super().setup()

    def call(self, k):
        from vln_ver_tpu_torch.evaluation.runner import (decode_outputs,
                                                         occupancy_hists)
        idx = self.order[k % len(self.order)]
        f, w, s = (x.index_select(0, idx) for x in self.pool)
        with torch.inference_mode():
            outs = self.model(f, w, s)
            dec, _ = decode_outputs(outs, self.model.cfg)
            hists = occupancy_hists(outs["occupancy_preds"],
                                    self.labels.index_select(0, idx),
                                    self.weight.index_select(0, idx),
                                    self.thresholds, self.model.cfg)
        self.boxes = [x.cpu().numpy() for x in dec]
        self.ssc.hist += hists.cpu().numpy().astype(np.float64)[0]
        return outs

    def install_spans(self, spans):
        """The per-layer metrics read the program's own spans."""

    def release(self):
        del self.labels, self.weight
        super().release()

    def check(self, control=None):
        """The numbers compared.  With ``control`` (``'tf32'``) the
        reference computed with TF32 on takes the program's place."""
        a = self.arch
        if control is None and set(self.kept) != self.check_at:
            raise RuntimeError(f"the window ended before the sampled batches "
                               f"{sorted(self.check_at)}")
        if control not in (None, "tf32"):
            raise ValueError(f"no control {control!r} for an fp32 cell")
        feats, w2p, shift = self.inputs(DTYPES[a.dtype])
        ref = Ref(a, make_weights(a, self.seed, self.device))
        worst = dict.fromkeys(CHECKED, 0.0)
        with torch.no_grad(), true_fp32():
            for k in sorted(self.check_at):
                idx = self.order[k % len(self.order)].tolist()
                for j, v in enumerate(idx):
                    ins = (feats[v:v + 1].float(), w2p[v:v + 1],
                           shift[v:v + 1])
                    r = ref.forward(*ins)
                    got = None
                    if control:
                        torch.backends.cuda.matmul.allow_tf32 = True
                        torch.backends.cudnn.allow_tf32 = True
                        got = ref.forward(*ins)
                        torch.backends.cuda.matmul.allow_tf32 = False
                        torch.backends.cudnn.allow_tf32 = False
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
        self.kept = {}
        return [self.number(name, v) for name, v in worst.items()]
