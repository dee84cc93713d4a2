"""Closed-loop training steps through the port's
``train.step.make_train_step`` (forward in train mode, losses and the
matching, backward, clip and AdamW), one object from set-up to the end.

Set-up builds the train state on the benchmark's weights and drives it
through its first ``follow_steps`` updates on distinct samples with the
window's own call; they are the warm-up too.  It keeps each of their
losses and the per-leaf norms of the first gradient as AdamW took it (its
first moment after one update over 1 - b1).  The window then goes on
from there.  At its step ``check_step``, drawn from the seed below
``check_within``, it keeps that step's loss and copies the parameters
just after it into buffers set aside in set-up (on the card, no sync),
so that the check holds a step of the window itself.

Traffic keys: ``pool`` samples (features, cameras, boxes and occupancy
labels, staged on the card), ``batch``, ``num_boxes``, ``cycles``,
``follow_steps``, ``check_within``, ``trace_seconds``.

The check: the plain reference follows the same updates from the same
weights (the same dropout draws, the configuration's matcher, its own
AdamW) through the window's checked step.  Compared are the first
update's loss by its relative gap (``loss``); the first gradient, by
the worst leaf's gap of norms (``first_grad``) and by the lower quartile
over the leaves of each leaf's elementwise gap (``first_grad_q25``); and
the per-leaf norms of the parameters' change from the start to just
after the checked step, by the median leaf's relative gap (``change``)
and by the worst leaf's (``change_worst``).  A worst leaf's gap is taken
relative to the reference's norm of that leaf or of the median leaf,
whichever is larger.  Elements whose first reference gradient is under
a thousandth of the median leaf's RMS gradient (a key's bias under the
softmax, parameters the loss does not reach) are left out of the change
and of ``first_grad_q25``.

The gradient of a sampling location is discontinuous at the edges of
the map's cells: a point within rounding of an edge takes the other
cell's slope on one side.  Such a point moves the gradient of every leaf
upstream of its location, about 58 % of the leaves, by up to a few
percent of a leaf's norm on some seeds (``first_grad`` reads that
tail).  The class, box and occupancy branches, the upsampler and the
last decoder layer's output, 42 % of the leaves, lie past every
sampling location, so ``first_grad_q25`` is steady from seed to seed
and still reads every leaf where the whole gradient is off, as under
TF32.  The gaps of the later followed updates' losses and of the
checked step's (``window_loss_gap``) carry the same kinks: the control
reads within their spread, so they are reported beside the numbers
(``counters``) and not compared.  A step whose loss is not finite, or
whose sparse lift dropped a visible query, is a failed one.
"""

from __future__ import annotations

import time

import torch

from verbench import traffic as T
from verbench.driver import Driver as Base
from verbench.driver import valid_taps
from verbench.flops import train_flop
from verbench.program import build_model
from verbench.reference.arch import make_weights
from verbench.reference.model import true_fp32
from verbench.reference.train import RefTrainer

KEYS = ("gt_boxes", "gt_labels", "gt_valid", "occ_dense")


def leaf_gap(got: dict, want: dict, leaves) -> float:
    """Worst |got - want| over max(want, median of want) across leaves."""
    med = float(torch.tensor([want[k] for k in leaves]).median())
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in leaves)


def leaf_quartile(got: dict, want: dict, floor: float) -> float:
    """The lower quartile over the leaves of ||got - want|| / ||want||,
    each leaf over its elements where |want| >= ``floor``."""
    gaps = []
    for n, w in want.items():
        keep = w.abs() >= floor
        if not bool(keep.any()):
            continue
        w64 = w[keep].double()
        g64 = got[n].to(w.device)[keep].double()
        gaps.append(float((g64 - w64).norm() / w64.norm()))
    gaps.sort()
    return gaps[len(gaps) // 4]


class Driver(Base):
    span_pairs = {"forward": ("start", "forward"),
                  "loss_match": ("forward", "losses"),
                  "backward": ("losses", "backward"),
                  "optimizer": ("backward", "update")}

    def plan(self):
        t = self.traffic
        self.batch = int(t["batch"])
        self.order = T.order(self.seed, int(t["pool"]), self.batch,
                             int(t.get("cycles", 200)))
        self.follow = int(t["follow_steps"])
        within = int(t["check_within"])
        self.check_step = self.sample(1, within, 3)[0]

    def pool_on_device(self):
        a, t, dev = self.arch, self.traffic, self.device
        w2p, shift = T.cameras(a, t, self.seed)
        gt = T.ground_truth(a, t, self.seed)
        pool = {"features": T.features(a, t, self.seed, dev),
                "world2pixel": torch.from_numpy(w2p).to(dev),
                "origin_shift": torch.from_numpy(shift).to(dev)}
        for k in KEYS:
            pool[k] = torch.stack([torch.from_numpy(g[k]) for g in gt]).to(dev)
        return pool

    def batch_at(self, pool, k):
        idx = torch.as_tensor(self.order[k % len(self.order)],
                              device=self.device)
        return {key: v.index_select(0, idx) for key, v in pool.items()}

    def train_config(self):
        from vln_ver_tpu_torch.train.state import TrainConfig
        tc = dict(self.arch.spec["train"])
        tc.pop("batch_size")
        return TrainConfig(**tc)

    def setup(self):
        from vln_ver_tpu_torch.train import (create_train_state,
                                             make_train_step)
        a = self.arch
        self.plan()
        weights = make_weights(a, self.seed, self.device)
        model, cfg = build_model(a, weights, self.device)
        del weights
        self.state = create_train_state(model, self.train_config())
        self.step_fn = make_train_step(cfg, self.state.tc)
        self.pool = self.pool_on_device()
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.snap = [torch.empty_like(p) for p in self.params]
        self.kept_loss = None
        self.free()
        self.follow_loss, self.first_grad, self.first_full = [], None, None
        for k in range(self.follow):
            m = self.call(k)
            self.follow_loss.append(float(m["loss"]))
            if k == 0:
                opt = self.state.optimizer
                self.first_full = {
                    n: (opt.state[p]["exp_avg"] / 0.1).cpu()
                    if "exp_avg" in opt.state.get(p, {})
                    else torch.zeros(p.shape)
                    for n, p in model.named_parameters()}
                self.first_grad = {n: float(g.double().norm())
                                   for n, g in self.first_full.items()}
        self.next_k = self.follow
        self.settle()

    def call(self, k):
        return self.step_fn(self.state, self.batch_at(self.pool, k),
                            self.seed)

    def keep(self, m):
        """The checked step's loss and the parameters just after it."""
        self.kept_loss = m["loss"]
        with torch.no_grad():
            for s, p in zip(self.snap, self.params):
                s.copy_(p)

    def run_window(self, seconds):
        metrics = []
        t0 = self.start_window()
        k = self.next_k
        checking = self.kept_loss is None
        while (time.perf_counter() - t0 < seconds
               or (checking and len(metrics) <= self.check_step)):
            m = self.call(k)
            if checking and len(metrics) == self.check_step:
                self.keep(m)
            metrics.append(m)
            k += 1
        self.close_window()
        self.next_k = k
        steps = len(metrics)
        self.units = self.attempted = steps * self.batch
        bad = sum(not torch.isfinite(m["loss"]) or int(m["sca_overflow"]) > 0
                  for m in metrics)
        self.failed = bad * self.batch
        self.counters["batch"] = self.batch

    def flop_per_unit(self):
        return train_flop(self.arch)

    def install_spans(self, spans):
        spans.on_module(self.state.model, "start", "forward")
        spans.on_call(self.state.optimizer, "zero_grad", "losses")
        spans.on_call(self.state, "apply_gradients", "backward", "update")

    def release(self):
        self.kept_loss = float(self.kept_loss)
        self.after = dict(zip(self.names, self.snap))
        del self.state, self.step_fn, self.pool, self.params, self.snap
        self.free()

    def reference(self, control=None):
        """The reference over the followed updates and the window's
        through its checked step (``control='tf32'``: with TF32 on):
        (losses, first gradients as AdamW took them, parameters after,
        starting parameters)."""
        a = self.arch
        pool = self.pool_on_device()
        start = make_weights(a, self.seed, self.device)
        ref = RefTrainer(a, start, self.arch.spec["train"])
        losses, first, taps, layers = [], None, 0, 0
        with true_fp32():
            if control == "tf32":
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
            for k in range(self.follow + self.check_step + 1):
                cap = []
                losses.append(float(ref.loss_and_grads(
                    self.batch_at(pool, k), self.seed, capture=cap)))
                if k == 0:
                    for loc, vis in cap:
                        taps += valid_taps(loc, vis, a.feat_h, a.feat_w)
                        layers += 1
                used = ref.update()
                if k == 0:
                    first = used
        self.counters["valid_taps_per_view_layer"] = taps / max(layers, 1)
        return losses, first, {n: p.detach() for n, p in ref.params.items()}, start

    def check(self, control=None):
        """The numbers compared.  With ``control`` the reference computed
        that way (``'tf32'``) takes the program's place.

        The change leaves out the elements whose first reference gradient
        is under a thousandth of the median leaf's RMS gradient (a key's
        bias under the softmax, parameters the loss does not reach): Adam
        moves them by round-off alone."""
        losses, first, after, start = self.reference()
        first_n = {n: float(g.double().norm()) for n, g in first.items()}
        if control:
            got_loss, got_full, got_after, _ = self.reference(control)
            got_first = {n: float(g.double().norm())
                         for n, g in got_full.items()}
        else:
            got_loss = self.follow_loss + [float("nan")] * self.check_step
            got_loss.append(self.kept_loss)
            got_first, got_after = self.first_grad, self.after
            got_full = self.first_full
        rms = torch.tensor([first_n[n] / g.numel() ** 0.5
                            for n, g in first.items()]).median()
        change, got_change = {}, {}
        for n, g in first.items():
            keep = g.abs() >= 1e-3 * float(rms)
            if not bool(keep.any()):
                continue
            p0 = start[n][keep].double()
            change[n] = float((after[n][keep].double() - p0).norm())
            got = got_after[n].to(self.device)[keep].double()
            got_change[n] = float((got - p0).norm())
        gaps = [abs(g - r) / abs(r) for g, r in zip(got_loss, losses)]
        self.counters["loss_gap_by_step"] = gaps[:self.follow]
        self.counters["window_loss_gap"] = gaps[-1]
        self.counters["check_step"] = self.check_step
        by_leaf = sorted(abs(got_change[n] - change[n]) / change[n]
                         for n in change)
        return [self.number("loss", gaps[0]),
                self.number("first_grad", leaf_gap(got_first, first_n,
                                                   list(first_n))),
                self.number("first_grad_q25", leaf_quartile(
                    got_full, first, 1e-3 * float(rms))),
                self.number("change", by_leaf[len(by_leaf) // 2]),
                self.number("change_worst", leaf_gap(got_change, change,
                                                     list(change)))]
